"""Fleet × mesh: R robots sharded over the device mesh.

The fleet axis (R independent control problems) is orthogonal to the
rollout axis K (docs/scaling.md): robots share NOTHING per solve, so the
natural multi-chip layout is whole robots per chip — `shard_map` over the
robot axis with ZERO collectives; each device runs its R/n robots' full
solves locally (the vmapped scan fleet, or the fused fleet kernels on a GPU).
This module executes that composition — it is the code behind
docs/scaling.md's "a fleet shards naturally as whole robots per chip"
paragraph, test-verified against the single-device fleet
(tests/test_fleet_sharded.py) and benchable via `bench.py --fleet R
--sharded`. The reference has no analog (one robot, one GPU —
reference src/main.cu:220).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.6 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

from mppi_gpu_tpu.batched import BatchedMPPIController
from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.controller import SolveInfo, SolveResult
from mppi_gpu_tpu.models.base import Dynamics
from mppi_gpu_tpu.ops.cost import Cost
from mppi_gpu_tpu.parallel.mesh import ROLLOUT_AXIS, make_mesh


class ShardedFleetController(BatchedMPPIController):
    """BatchedMPPIController whose robots are sharded over a mesh.

    `solve_batch` keeps the exact single-device fleet semantics (same
    shapes, same per-robot keys, same results — each robot's solve is an
    unchanged local computation, so agreement is exact, not
    reduction-order-tolerant like the K-sharded solve)."""

    def __init__(
        self,
        cfg: MPPIConfig,
        n_robots: int,
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
        *,
        goals: jax.Array | None = None,
        mesh: Mesh | None = None,
        rollout_backend: str = "auto",
        axis_name: str = ROLLOUT_AXIS,
    ) -> None:
        mesh = mesh if mesh is not None else make_mesh()
        n = mesh.shape[axis_name]
        if n_robots % n != 0:
            raise ValueError(
                f"n_robots={n_robots} must divide evenly over {n} devices"
            )
        # resolve 'auto' against the MESH's platform (may be a forced-CPU
        # virtual mesh), exactly like ShardedMPPIController
        if rollout_backend == "auto":
            from mppi_gpu_tpu.controller import resolve_backend
            from mppi_gpu_tpu.models import dynamics_for_config
            from mppi_gpu_tpu.ops.cost import make_cost

            dyn0 = dynamics if dynamics is not None else dynamics_for_config(cfg)
            cost0 = cost if cost is not None else make_cost(cfg)
            rollout_backend = resolve_backend(
                "auto", dyn0, cost0, platform=mesh.devices.flat[0].platform
            )
        super().__init__(
            cfg, n_robots, dynamics, cost, goals=goals,
            rollout_backend=rollout_backend,
        )
        self.mesh = mesh

        rep = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)
        cost_specs = (
            jax.tree_util.tree_map(
                lambda ax: P(axis_name) if ax == 0 else P(), self._cost_axes,
                is_leaf=lambda x: x is None,
            )
            if self._cost_axes is not None
            else rep(self.cost)
        )
        out_specs = SolveResult(
            action=P(axis_name),
            u_next=P(axis_name),
            info=SolveInfo(
                costs=P(axis_name), beta=P(axis_name), eta=P(axis_name),
                weights=P(axis_name), u_seq=P(axis_name),
            ),
        )
        self._solve_batch = jax.jit(
            shard_map(
                self._solve_batch_fn,
                mesh=mesh,
                in_specs=(
                    rep(self.dynamics), cost_specs,
                    P(axis_name), P(axis_name), P(axis_name),
                    P(), P(), P(),
                ),
                out_specs=out_specs,
                check_vma=False,
            )
        )
