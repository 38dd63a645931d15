"""mppi_gpu_tpu — an MPPI (Model Predictive Path Integral) control framework in JAX.

A JAX/XLA/Pallas re-design of the capabilities of the reference CUDA
implementation (NicolayP/mppi_gpu): K-sample stochastic rollouts of a dynamics
model over horizon T, softmin-weighted action updates, and a receding-horizon
closed loop against a ground-truth world simulator. It runs on NVIDIA GPUs
and, for tests, on the CPU.

Architecture:
  * the reference's one-CUDA-thread-per-rollout kernel (reference
    src/point_mass.cu:493-508) becomes either a single jitted XLA program
    (a `lax.scan` over T, any dynamics) or two fused Pallas kernels with one
    rollout per lane (ops/fused_rollout.py, the analytic families);
  * the reference's multi-launch min/sum reduction ladders
    (src/point_mass.cu:533-575, 628-666) become XLA reductions plus
    `pmin`/`psum` collectives over a `jax.sharding.Mesh`;
  * the reference's per-timestep `update_act` host loop — its acknowledged
    bottleneck (src/point_mass.cu:187) — becomes one K×(T·A) contraction,
    or a per-block reduction inside the fused update kernel;
  * cuRAND per-thread state becomes counter-based `jax.random` keys (or the
    counter-based generator of ops/noise.py inside the fused kernels) —
    deterministic and replay-friendly.
"""

from mppi_gpu_tpu.config import MPPIConfig, load_config
from mppi_gpu_tpu.controller import (
    MPPIController,
    SolveInfo,
    SolveResult,
    mppi_solve,
    mppi_solve_deterministic,
)
from mppi_gpu_tpu.ops.cost import register_cost
from mppi_gpu_tpu.ops.fused_rollout import register_family

__version__ = "0.1.0"

__all__ = [
    "MPPIConfig",
    "load_config",
    "MPPIController",
    "SolveInfo",
    "SolveResult",
    "mppi_solve",
    "mppi_solve_deterministic",
    "register_cost",
    "register_family",
]
