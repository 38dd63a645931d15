"""Sharded MPPI solve: K rollouts over a device mesh via `shard_map`.

Each device rolls out K/n trajectories with decorrelated noise (key folded by
mesh position), then the softmin + update use exactly three collectives —
`pmin` (β), `psum` (η), `psum` (ΔU ∈ ℝ^{T×a}), which XLA hands to NCCL on
GPUs. The reference has no distributed story at all (single process, single
GPU); this module is the scale-out the survey's §2 checklist calls for.

Determinism note: the sharded solve is NOT bit-identical to the single-chip
solve (different noise placement, different reduction order) but is identical
in distribution; tests check statistical agreement of the resulting control
sequences.
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.6 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.controller import (
    SolveInfo,
    SolveResult,
    mppi_solve,
    MPPIController,
)
from mppi_gpu_tpu.models.base import Dynamics
from mppi_gpu_tpu.ops.cost import Cost
from mppi_gpu_tpu.parallel.mesh import ROLLOUT_AXIS, make_mesh


def sharded_mppi_solve(
    mesh: Mesh,
    dyn: Dynamics,
    cost: Cost,
    x0: jax.Array,
    U: jax.Array,
    key: jax.Array,
    sigma: jax.Array,
    lambda_: jax.Array,
    max_a: jax.Array,
    *,
    K: int,
    clamp: bool = True,
    axis_name: str = ROLLOUT_AXIS,
    rollout_backend: str = "scan",
    antithetic: bool = False,
    ou_beta: float = 0.0,
    opt_iters: int = 1,
    sampler: str = "auto",
) -> SolveResult:
    """One MPPI solve with K rollouts sharded over `mesh`'s `axis_name` axis.

    Inputs are replicated (they are small: x0 (s,), U (T,a), scalars); the
    (T, K, a) noise tensor and (K,) cost/weight vectors only ever exist
    device-local. Outputs: action/U replicated; per-rollout diagnostics in
    `info` come back sharded over K.
    """
    n = mesh.shape[axis_name]
    if K % n != 0:
        raise ValueError(f"K={K} must divide evenly over {n} devices")
    k_loc = K // n
    if antithetic and k_loc % 2 != 0:
        raise ValueError(
            f"antithetic sampling needs an even per-device rollout count; "
            f"K={K} over {n} devices gives {k_loc} per device — otherwise one "
            f"rollout per shard would silently drop and diagnostics would not "
            f"have shape (K,)"
        )

    def local_solve(dyn, cost, x0, U, key, sigma, lambda_, max_a):
        me = jax.lax.axis_index(axis_name)
        local_key = jax.random.fold_in(key, me)
        # sampler note: shard_map is SPMD, not batching — each device runs
        # the UNBATCHED program on its folded key, so the fast rbg sampler
        # keeps per-device streams equal to the oracle's unbatched
        # reconstruction (unlike vmap; see controller._standard_normal_tiled)
        return mppi_solve(
            dyn, cost, x0, U, local_key, sigma, lambda_, max_a,
            K=k_loc, clamp=clamp, axis_name=axis_name,
            rollout_backend=rollout_backend, antithetic=antithetic,
            ou_beta=ou_beta, opt_iters=opt_iters,
            sampler=sampler,
        )

    out_specs = SolveResult(
        action=P(),
        u_next=P(),
        info=SolveInfo(
            costs=P(axis_name),
            beta=P(),
            eta=P(),
            weights=P(axis_name),
            u_seq=P(),
        ),
    )
    fn = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(dyn, cost, x0, U, key, sigma, lambda_, max_a)


class ShardedMPPIController(MPPIController):
    """Drop-in MPPIController that runs the solve over a device mesh."""

    def __init__(
        self,
        cfg: MPPIConfig,
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
        *,
        mesh: Mesh | None = None,
        rollout_backend: str = "auto",
        sampler: str = "auto",
    ) -> None:
        # base init with the generic backend: its single-device jitted solve
        # is replaced below, so don't resolve 'auto' against the wrong
        # (default) platform here
        super().__init__(cfg, dynamics, cost, rollout_backend="scan")
        self.mesh = mesh if mesh is not None else make_mesh()
        # resolve the *requested* backend against the mesh's platform (may
        # differ from the default backend, e.g. a forced-CPU virtual mesh)
        from mppi_gpu_tpu.controller import resolve_backend

        self.rollout_backend = resolve_backend(
            rollout_backend,
            self.dynamics,
            self.cost,
            platform=self.mesh.devices.flat[0].platform,
        )
        self.sampler = sampler
        solve = partial(
            sharded_mppi_solve,
            self.mesh,
            K=cfg.samples,
            clamp=cfg.clamp_action,
            rollout_backend=self.rollout_backend,
            antithetic=cfg.antithetic,
            ou_beta=cfg.noise_beta,
            opt_iters=cfg.opt_iters,
            sampler=sampler,
        )
        self._solve = jax.jit(solve)
