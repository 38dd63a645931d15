"""Batched multi-robot MPPI: one jitted program solves B independent control
problems at once via `jax.vmap`.

No reference analog (the reference is strictly one controller, one robot):
a fleet of B robots at K samples each gives the accelerator a (B·K)-wide
batch, which keeps it fed when a single robot's K is modest. Dynamics and cost are shared; goals
may differ per robot (the common fleet case) by vmapping over the cost's
goal leaf.

Two fleet execution modes:

- **scan** — `jax.vmap` over the scan solve: composes trivially, works for
  ANY dynamics/cost (including MLP/hybrid models).
- **pallas** — the fused kernels of ops/fused_rollout.py with the robot as
  grid axis 0: grid (R, blocks), each block reading its robot's key, U and
  parameter row (x0, goal). Kernel A writes every robot's costs, XLA takes
  each robot's softmin, kernel B reduces every robot's ΔU — the R·T·K·a
  noise tensor is never materialized. `auto` picks it on a GPU whenever a
  fused family covers the (dynamics, cost) pair.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.controller import (
    MPPIController,
    SolveInfo,
    SolveResult,
    mppi_solve,
    shift_action_seq,
)
from mppi_gpu_tpu.models.base import Dynamics
from mppi_gpu_tpu.ops.cost import Cost
from mppi_gpu_tpu.ops.softmin import softmin_weights


def _has_goal(c) -> bool:
    return dataclasses.is_dataclass(c) and any(
        f.name == "goal" for f in dataclasses.fields(c)
    )


def _batch_goals(cost: Cost, goals: jax.Array):
    """(batched_cost, vmap_axes): stack per-robot goals onto the cost's
    `goal` leaf — works for ANY registered cost dataclass with a `goal`
    field (quadratic, quadrotor-hover, …), or one wrapping such a cost in a
    `base` field (the obstacle cost)."""
    none_axes = jax.tree_util.tree_map(lambda _: None, cost)
    if _has_goal(cost):
        return (
            dataclasses.replace(cost, goal=goals),
            dataclasses.replace(none_axes, goal=0),
        )
    if hasattr(cost, "base") and _has_goal(cost.base):
        return (
            dataclasses.replace(cost, base=dataclasses.replace(cost.base, goal=goals)),
            dataclasses.replace(
                none_axes, base=dataclasses.replace(none_axes.base, goal=0)
            ),
        )
    raise TypeError(
        f"per-robot goals need a cost with a 'goal' field; "
        f"{type(cost).__name__} has none (its target is built in)"
    )


class BatchedMPPIController(MPPIController):
    """Solves B control problems per call: states (B, s), sequences
    (B, T, a), keys (B,). `solve_batch` returns a SolveResult whose leaves
    all carry a leading B axis."""

    def __init__(
        self,
        cfg: MPPIConfig,
        n_robots: int,
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
        *,
        goals: jax.Array | None = None,  # (B, s) per-robot goals (optional)
        rollout_backend: str = "auto",
        sampler: str = "auto",
    ) -> None:
        # Fleet sampler resolution: the scan fleet is `vmap` over per-robot
        # solves, and the fast rbg sampler is NOT vmap-elementwise (a
        # vmapped RngBitGenerator draw matches the unbatched draw only for
        # robot 0 — see controller._standard_normal_tiled). "auto" therefore
        # resolves to the vmap-exact threefry erfinv sampler here, keeping
        # the fleet's decomposability invariant: solve_batch(r) is
        # BIT-equal to a single-robot solve with the same key and
        # sampler="erfinv" (tested in test_batched/test_fleet_sharded).
        # Pass sampler="rbg-boxmuller" explicitly to trade that invariant
        # for sampling speed (still deterministic, just not
        # robot-decomposable). The pallas fleet draws each robot's noise
        # from its own key in-kernel and keeps decomposability regardless.
        if sampler == "auto":
            from mppi_gpu_tpu.controller import resolve_sampler

            sampler = resolve_sampler("auto")
            if sampler in ("rbg", "rbg-boxmuller"):
                sampler = "erfinv"
        super().__init__(
            cfg, dynamics, cost, rollout_backend=rollout_backend,
            sampler=sampler,
        )
        self.n_robots = n_robots

        cost_axes = None
        if goals is not None:
            goals = jnp.asarray(goals, jnp.float32)
            if goals.shape != (n_robots, cfg.state_dim):
                raise ValueError(
                    f"goals must be ({n_robots}, {cfg.state_dim}), got {goals.shape}"
                )
            self.cost, cost_axes = _batch_goals(self.cost, goals)
        self._cost_axes = cost_axes  # consumed by ShardedFleetController

        if self.rollout_backend in ("pallas", "pallas-interpret"):
            self._solve_batch_fn = self._build_pallas_fleet(cfg, cost_axes)
        else:
            solve = partial(
                mppi_solve, K=cfg.samples, clamp=cfg.clamp_action,
                rollout_backend="scan", antithetic=cfg.antithetic,
                ou_beta=cfg.noise_beta, opt_iters=cfg.opt_iters,
                sampler=self.sampler,
            )
            self._solve_batch_fn = jax.vmap(
                solve, in_axes=(None, cost_axes, 0, 0, 0, None, None, None)
            )
        # the unjitted fleet solve (`_solve_batch_fn`) is robot-count-
        # agnostic: ShardedFleetController re-wraps it in shard_map over
        # the robot axis, each shard solving its R/n robots locally
        self._solve_batch = jax.jit(self._solve_batch_fn)

    def _build_pallas_fleet(self, cfg: MPPIConfig, cost_axes):
        """Whole-fleet solve through the fused kernels with the robot as a
        grid axis; only the per-robot softmin and the clamp/shift tail run
        in XLA. Returned unjitted (the caller jits / shard_maps it)."""
        from mppi_gpu_tpu.ops import fused_rollout as fr

        fr.family_for(self.dynamics, self.cost)  # TypeError if no family fuses it
        K, T, A = cfg.samples, cfg.horizon, cfg.action_dim
        interpret = self.rollout_backend == "pallas-interpret"

        def solve_fleet(dyn, cost, xs, Us, keys, sigma, lambda_, max_a):
            plan = fr.plan_for(
                dyn, cost, K, T, A, R=xs.shape[0], antithetic=cfg.antithetic,
                ou_beta=cfg.noise_beta,
            )
            rows = fr.pack_rows(dyn, cost, xs, sigma, plan, cost_axes)

            def core_unew(Us, keys_it):
                words = fr.robot_words(keys_it)
                S = fr.fused_costs(words, Us, rows, plan, interpret=interpret)
                w = jax.vmap(lambda s: softmin_weights(s, lambda_).weights)(S)
                u_new = Us + fr.fused_update(words, rows, w, plan, interpret=interpret)
                if cfg.clamp_action:
                    u_new = jnp.clip(u_new, -max_a, max_a)
                return S, u_new

            if cfg.opt_iters > 1:
                # iterated MPPI for the fleet kernel: same per-iteration key
                # folding as mppi_solve's opt_iters path, vmapped over robots
                fold_r = jax.vmap(jax.random.fold_in, (0, None))

                def body(Us, j):
                    _, u_new = core_unew(Us, fold_r(keys, j))
                    return u_new, None

                Us, _ = jax.lax.scan(body, Us, jnp.arange(cfg.opt_iters - 1))
                keys = fold_r(keys, cfg.opt_iters - 1)
            S, u_new = core_unew(Us, keys)

            def tail(S_r, u_new_r):
                # β/η/weights for SolveInfo parity with the scan fleet (XLA
                # shares them with the solve's own softmin)
                sm = softmin_weights(S_r, lambda_)
                return SolveResult(
                    action=u_new_r[0],
                    u_next=shift_action_seq(u_new_r),
                    info=SolveInfo(
                        costs=S_r[:K], beta=sm.beta, eta=sm.eta,
                        weights=sm.weights[:K], u_seq=u_new_r,
                    ),
                )

            return jax.vmap(tail)(S, u_new)

        return solve_fleet

    # -- batched state helpers --------------------------------------------
    def init_action_seqs(self) -> jax.Array:
        return jnp.broadcast_to(
            self.init_action_seq()[None],
            (self.n_robots, self.cfg.horizon, self.cfg.action_dim),
        )

    def init_keys(self) -> jax.Array:
        return jax.random.split(self.init_key(), self.n_robots)

    # -- batched solve -----------------------------------------------------
    def solve_batch(
        self, xs: jax.Array, Us: jax.Array, keys: jax.Array
    ) -> SolveResult:
        """One MPPI solve per robot, all in a single XLA program."""
        return self._solve_batch(
            self.dynamics, self.cost, xs, Us, keys,
            self.sigma, self.lambda_, self.max_a,
        )

    def solve_batch_auto(
        self, xs: jax.Array, Us: jax.Array, keys: jax.Array, step: int
    ) -> SolveResult:
        return self.solve_batch(xs, Us, jax.vmap(jax.random.fold_in, (0, None))(keys, step))
