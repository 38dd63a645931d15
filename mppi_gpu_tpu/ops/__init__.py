"""Compute ops for the MPPI solve: costs, rollouts, softmin weighting.

The JAX paths here are the semantic ground truth (and the CPU-runnable path);
`fused_rollout` provides the fused GPU kernels for the rollout and the
weighted update, drawing their noise from `noise`.
"""

from mppi_gpu_tpu.ops.cost import COST_REGISTRY, QuadraticCost, make_cost
from mppi_gpu_tpu.ops.rollout import rollout_costs, rollout_trajectories
from mppi_gpu_tpu.ops.softmin import softmin_weights

__all__ = [
    "COST_REGISTRY",
    "QuadraticCost",
    "make_cost",
    "rollout_costs",
    "rollout_trajectories",
    "softmin_weights",
]
