"""MPPI controller: the full solve as ONE jitted XLA program.

The reference performs one control solve as ~2T+10 separate kernel launches
with host synchronization between phases (reference src/point_mass.cu:129-203:
sim → beta ladder → exp → nabla ladder → weights → per-t update_act ladder →
shift). Here the entire phase sequence is a single pure function under `jit`:
XLA fuses the softmin pipeline, the weighted-noise update is one K×(T·A)
contraction (this was the reference's flagged bottleneck,
src/point_mass.cu:187), and nothing round-trips to the host.

Phase mapping (reference → here):
    sim_gpu_kernel_      → ops.rollout.rollout_costs (lax.scan over T) or the
                           fused kernels (ops.fused_rollout)
    beta/exp/nabla/weights → ops.softmin.softmin_weights
    update_act + copy_act  → one einsum  U += Σ_k w_k ε_k
    (new, wired)           → clamp to ±max_a
    shift_act              → roll-by-one with repeated last step
                             (src/point_mass.cu:805-824 semantics)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.models.base import Dynamics
from mppi_gpu_tpu.ops.cost import Cost, make_cost
from mppi_gpu_tpu.ops.noise import noise_tensor
from mppi_gpu_tpu.ops.rollout import (
    LANE,
    rollout_costs,
    rollout_costs_tiled,
    round_up_k,
)
from mppi_gpu_tpu.ops.softmin import softmin_weights

# Cost assigned to padded rollouts in the tiled layout: +inf, so
# exp(-(inf-β)/λ) is exactly 0 and padding drops out of β, η and ΔU with no
# masking on the hot path (the XLA analog of the Pallas kernels' K-masking).
# Deliberately inf and not a big finite value: when every REAL rollout
# diverges to inf cost, β-S = inf-inf = NaN must propagate to the action so
# utils.guard.ControllerDiverged fires — a finite pad cost would win the
# softmin and silently launder divergence into a finite garbage action.
# (A plain Python float, NOT a jnp scalar: a module-level jnp constant would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize in the multi-process bootstrap.)
PAD_COST = float("inf")


class SolveInfo(NamedTuple):
    """Per-solve diagnostics — the analog of the reference's `get_inf` bulk
    download (src/point_mass.cu:236-262). All values are local to the shard
    when running under a mesh, except beta/eta which are global."""

    costs: jax.Array    # (K,) per-rollout total cost S_k
    beta: jax.Array     # scalar: min_k S_k
    eta: jax.Array      # scalar: Σ_k exp(−(S_k−β)/λ)
    weights: jax.Array  # (K,) softmin weights
    u_seq: jax.Array    # (T, a) updated nominal sequence BEFORE the shift


class SolveResult(NamedTuple):
    action: jax.Array   # (a,) — U_new[0], the action to execute now
    u_next: jax.Array   # (T, a) — shifted sequence for the next solve
    info: SolveInfo


def resolve_sampler(sampler: str = "auto") -> str:
    """Resolve the scan-path normal sampler name. ``auto`` honors the
    MPPI_SCAN_SAMPLER env override and otherwise picks ``rbg`` — the fast
    default for UNBATCHED solves (see :func:`_standard_normal_tiled` for
    the vmap caveat that makes batched fleet contexts resolve
    differently)."""
    import os as _os

    if sampler != "auto":
        return sampler
    return _os.environ.get("MPPI_SCAN_SAMPLER", "rbg")


def _standard_normal_tiled(
    key: jax.Array, shape: tuple[int, ...], sampler: str = "auto"
) -> jax.Array:
    """Standard normals for the tiled sampler.

    Default (``sampler="rbg"``): raw bits from XLA's `RngBitGenerator`
    (the jax ``rbg`` key impl) through jax.random.normal's erfinv
    inverse-CDF — elementwise, so it fuses into its consumer, with the bits
    nearly free. Which sampler is fastest on the GPU is not measured yet.

    The incoming threefry key is deterministically widened to an rbg key
    (its two words tiled to four), so callers keep plain `jax.random.key`
    semantics; fold_in/split happen on the threefry key BEFORE conversion.

    **vmap caveat**: `RngBitGenerator` is NOT vmap-elementwise — a vmapped
    rbg draw matches the unbatched draw only for batch element 0 (jax
    documents this for the rbg/unsafe_rbg impls). Anything that relies on
    batch decomposability (the fleet's "vmap of solves == each solve"
    invariant) must use a threefry sampler, which IS vmap-exact; that is
    why `BatchedMPPIController` resolves ``auto`` to ``erfinv`` instead
    (batched.py) while unbatched/shard_map contexts get ``rbg``
    (shard_map is SPMD, not batching: each device runs the unbatched
    program, so per-device streams equal the oracle's unbatched
    reconstruction — asserted down to the 2-OS-process Gloo cluster in
    tests/_multiproc_check.py).

    ``sampler="erfinv"``: jax.random.normal on the threefry key (bit-stable
    across XLA versions, unlike RngBitGenerator's stream, and vmap-exact);
    ``"rbg-boxmuller"``: Box-Muller over rbg raw bits (lane-axis concat —
    concatenates halves); ``"boxmuller"``: Box-Muller over threefry
    uniforms. All are exact samplers (Box-Muller's
    radius caps at √(2·24·ln2) ≈ 5.8σ from the 24-bit uniform); the choice
    only changes WHICH normals a key maps to, and sample_noise's flat view
    follows automatically."""
    sampler = resolve_sampler(sampler)
    if sampler == "erfinv":
        return jax.random.normal(key, shape, jnp.float32)
    if sampler in ("rbg", "rbg-boxmuller"):
        data = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
        key = jax.random.wrap_key_data(jnp.tile(data, 2)[:4], impl="rbg")
        if sampler == "rbg":
            return jax.random.normal(key, shape, jnp.float32)
    elif sampler != "boxmuller":
        raise ValueError(f"unknown sampler '{sampler}'")
    half = shape[:-1] + (shape[-1] // 2,)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, half, jnp.float32)
    u2 = jax.random.uniform(k2, half, jnp.float32)
    r = jnp.sqrt(-2.0 * jnp.log1p(-u1))
    th = (2.0 * jnp.pi) * u2
    return jnp.concatenate([r * jnp.cos(th), r * jnp.sin(th)], axis=-1)


def sample_noise_tiled(
    key: jax.Array,
    T: int,
    K: int,
    action_dim: int,
    sigma: jax.Array,
    *,
    antithetic: bool = False,
    ou_beta: float = 0.0,
    sampler: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """ε ~ N(0, diag(σ²)) in the production tiled layout: returns
    ``(eps (T, a, R, 128), valid (R, 128) bool)`` with R a multiple of 8 —
    rollouts live on the two minor axes (see ops/rollout.py). K is padded
    up to whole tiles; `valid` marks the real rollouts (padded ones get
    cost=PAD_COST so their softmin weight underflows to exactly 0).

    Counter-based threefry: fully deterministic given the key — replaces the
    reference's stateful cuRAND per-thread states (src/point_mass.cu:780)
    with replayable keys.

    With `antithetic`, rollouts come in mirrored pairs (ε, −ε) — the mirror
    half is stacked along the R axis: same marginals, lower-variance softmin
    update, half the PRNG work.

    With `ou_beta` ∈ (0, 1), noise follows the stationary OU recursion
    e_t = β e_{t−1} + √(1−β²) ν_t over the horizon: unchanged per-step
    marginals (still N(0, σ²)) but time-correlated — smoother sampled action
    sequences, which rewards smoother controls out of the softmin."""
    Keff = K // 2 if antithetic else K
    Rr = round_up_k(Keff) // LANE
    nu = _standard_normal_tiled(key, (T, action_dim, Rr, LANE), sampler)
    if ou_beta > 0.0:
        c = (1.0 - ou_beta**2) ** 0.5  # keeps the stationary variance at σ²

        def body(prev, n):
            e = ou_beta * prev + c * n
            return e, e

        _, tail = jax.lax.scan(body, nu[0], nu[1:])
        nu = jnp.concatenate([nu[:1], tail], axis=0)
    sigma_col = jnp.broadcast_to(
        jnp.asarray(sigma, jnp.float32), (action_dim,)
    )[:, None, None]
    eps = sigma_col * nu
    idx = jax.lax.broadcasted_iota(jnp.int32, (Rr, LANE), 0) * LANE + (
        jax.lax.broadcasted_iota(jnp.int32, (Rr, LANE), 1)
    )
    valid = idx < Keff
    if antithetic:
        eps = jnp.concatenate([eps, -eps], axis=2)
        valid = jnp.concatenate([valid, valid], axis=0)
    return eps, valid


def sample_noise(
    key: jax.Array,
    T: int,
    K: int,
    action_dim: int,
    sigma: jax.Array,
    *,
    antithetic: bool = False,
    ou_beta: float = 0.0,
    sampler: str = "auto",
) -> jax.Array:
    """The (T, K, a) rollout-rank view of the EXACT noise stream the tiled
    scan solve consumes for these arguments (the debug/oracle form — the
    scan-backend analog of ops.noise.noise_tensor). Rollout k
    is tile row ``k // 128``, lane ``k % 128`` of :func:`sample_noise_tiled`;
    under `antithetic` the second K/2 rollouts are the exact mirrors of the
    first."""
    eps_t, _ = sample_noise_tiled(
        key, T, K, action_dim, sigma, antithetic=antithetic, ou_beta=ou_beta,
        sampler=sampler,
    )
    Keff = K // 2 if antithetic else K
    Rr = eps_t.shape[2] // (2 if antithetic else 1)
    flat = jnp.swapaxes(
        eps_t[:, :, :Rr].reshape(T, action_dim, Rr * LANE), 1, 2
    )[:, :Keff]
    if antithetic:
        flat = jnp.concatenate([flat, -flat], axis=1)
    return flat


def shift_action_seq(u_seq: jax.Array) -> jax.Array:
    """Receding-horizon shift with repeated last action
    (reference `shift_act`, src/point_mass.cu:805-824)."""
    return jnp.concatenate([u_seq[1:], u_seq[-1:]], axis=0)


def solve_from_costs(
    S: jax.Array,           # (K,) rollout costs
    eps: jax.Array,         # (T, K, a) the noise that produced them
    U: jax.Array,           # (T, a) nominal sequence
    lambda_: jax.Array,
    max_a: jax.Array,       # (a,)
    *,
    clamp: bool,
    axis_name: str | None = None,
) -> SolveResult:
    """Softmin-weighted update + clamp + shift. Shared tail for every rollout
    backend (scan / Pallas) and every execution mode (single chip / mesh)."""
    sm = softmin_weights(S, lambda_, axis_name=axis_name)
    # U[t] += Σ_k w_k ε_k[t]  — the reference's per-t reduction ladder
    # (update_act_kernel + sum_red_adim, src/point_mass.cu:668-741, 828-926)
    # collapsed into one contraction over K.
    dU = jnp.einsum(
        "tka,k->ta", eps, sm.weights, precision=jax.lax.Precision.HIGHEST
    )
    if axis_name is not None:
        dU = jax.lax.psum(dU, axis_name)
    u_new = U + dU
    if clamp:
        u_new = jnp.clip(u_new, -max_a, max_a)
    return SolveResult(
        action=u_new[0],
        u_next=shift_action_seq(u_new),
        info=SolveInfo(costs=S, beta=sm.beta, eta=sm.eta, weights=sm.weights, u_seq=u_new),
    )


def solve_from_costs_tiled(
    S: jax.Array,           # (R, 128) rollout costs, padded entries PAD_COST
    eps: jax.Array,         # (T, a, R, 128) the noise that produced them
    U: jax.Array,           # (T, a) nominal sequence
    lambda_: jax.Array,
    max_a: jax.Array,       # (a,)
    *,
    K: int,
    antithetic: bool,
    clamp: bool,
    axis_name: str | None = None,
) -> SolveResult:
    """Tiled-layout softmin update + clamp + shift. Identical math to
    :func:`solve_from_costs` — padded rollouts carry PAD_COST so their
    weights underflow to exactly 0, and SolveInfo exposes only the K real
    rollouts (in the same order as the flat view :func:`sample_noise`)."""
    sm = softmin_weights(S.reshape(-1), lambda_, axis_name=axis_name)
    # a matrix-vector product: HIGHEST keeps f32 (not TF32) at no cost
    dU = jnp.einsum(
        "tark,rk->ta", eps, sm.weights.reshape(S.shape),
        precision=jax.lax.Precision.HIGHEST,
    )
    if axis_name is not None:
        dU = jax.lax.psum(dU, axis_name)
    u_new = U + dU
    if clamp:
        u_new = jnp.clip(u_new, -max_a, max_a)
    Keff = K // 2 if antithetic else K
    half = (S.shape[0] // 2) * LANE if antithetic else 0

    def valid_view(v: jax.Array) -> jax.Array:  # (R*128,) -> (K,)
        if antithetic:
            return jnp.concatenate([v[:Keff], v[half:half + Keff]])
        return v[:K]

    return SolveResult(
        action=u_new[0],
        u_next=shift_action_seq(u_new),
        info=SolveInfo(
            costs=valid_view(S.reshape(-1)), beta=sm.beta, eta=sm.eta,
            weights=valid_view(sm.weights), u_seq=u_new,
        ),
    )


def mppi_solve_deterministic(
    dyn: Dynamics,
    cost: Cost,
    x0: jax.Array,
    U: jax.Array,
    eps: jax.Array,
    lambda_: jax.Array,
    max_a: jax.Array,
    *,
    clamp: bool = True,
    axis_name: str | None = None,
) -> SolveResult:
    """One MPPI solve with *injected* noise — the parity/testing mode. The
    reference's global ε buffer round-trip (src/point_mass_gpu.cu:123-129)
    makes the same injection natural there; oracles diff against this."""
    S = rollout_costs(dyn, cost, x0, U, eps)
    return solve_from_costs(S, eps, U, lambda_, max_a, clamp=clamp, axis_name=axis_name)


def mppi_solve(
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
    axis_name: str | None = None,
    rollout_backend: str = "scan",
    antithetic: bool = False,
    ou_beta: float = 0.0,
    opt_iters: int = 1,
    sampler: str = "auto",
) -> SolveResult:
    """One full MPPI solve: sample ε, roll out K trajectories over T, softmin
    update, clamp, shift. Pure and jittable; `K` is per-shard when running
    under `shard_map` with `axis_name` set. The pallas backends draw ε from
    the counter-based generator (ops/noise.py) inside the kernels; the scan
    backend samples with `sampler`.

    `opt_iters > 1` is ITERATED MPPI: the softmin update is applied to the
    nominal sequence `opt_iters` times (fresh noise per iteration — keys
    fold by iteration index) before `U[0]` is executed and the shift
    happens once. Each extra iteration re-centers the sampling distribution
    on the updated sequence, sharpening the importance-sampling estimate —
    standard MPPI practice the reference lacks (its loop hardcodes one
    update per cycle, src/main.cu:326-374). Diagnostics (`SolveInfo`) are
    the FINAL iteration's."""
    if opt_iters > 1:
        solve_once = partial(
            mppi_solve, dyn, cost, x0, K=K, clamp=clamp, axis_name=axis_name,
            rollout_backend=rollout_backend, antithetic=antithetic,
            ou_beta=ou_beta, opt_iters=1, sampler=sampler,
        )

        def body(U, j):
            r = solve_once(U, jax.random.fold_in(key, j), sigma, lambda_, max_a)
            return r.info.u_seq, None  # updated sequence BEFORE the shift

        U, _ = jax.lax.scan(body, U, jnp.arange(opt_iters - 1))
        return solve_once(
            U, jax.random.fold_in(key, opt_iters - 1), sigma, lambda_, max_a
        )
    T, a = U.shape
    if rollout_backend == "scan":
        import os as _os

        if _os.environ.get("MPPI_SCAN_LAYOUT", "tiled") == "flat":
            # escape hatch: the pre-round-4 flat layout, for user dynamics
            # that cannot run under per-sample vmap (none known — the
            # Dynamics protocol requires it) or for A/B measurement
            eps = sample_noise(
                key, T, K, a, sigma, antithetic=antithetic, ou_beta=ou_beta,
                sampler=sampler,
            )
            S = rollout_costs(dyn, cost, x0, U, eps)
            return solve_from_costs(
                S, eps, U, lambda_, max_a, clamp=clamp, axis_name=axis_name
            )
        eps, valid = sample_noise_tiled(
            key, T, K, a, sigma, antithetic=antithetic, ou_beta=ou_beta,
            sampler=sampler,
        )
        S = rollout_costs_tiled(dyn, cost, x0, U, eps)
        S = jnp.where(valid, S, PAD_COST)
        return solve_from_costs_tiled(
            S, eps, U, lambda_, max_a, K=K, antithetic=antithetic,
            clamp=clamp, axis_name=axis_name,
        )
    if rollout_backend in ("pallas", "pallas-interpret"):
        return pallas_solve(
            dyn, cost, x0, U, key, sigma, lambda_, max_a,
            K=K, clamp=clamp, axis_name=axis_name, antithetic=antithetic,
            ou_beta=ou_beta,
            interpret=rollout_backend == "pallas-interpret",
        )
    raise ValueError(f"unknown rollout backend '{rollout_backend}'")


def pallas_solve(
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
    axis_name: str | None = None,
    antithetic: bool = False,
    ou_beta: float = 0.0,
    interpret: bool = False,
) -> SolveResult:
    """Fused-kernel MPPI solve: the (T, K, a) noise tensor never exists in
    device memory. Kernel A rolls out and returns only costs; the softmin
    runs in XLA (with pmin/psum across the mesh when sharded); kernel B
    regenerates the same noise and reduces ΔU per block. See
    ops/fused_rollout.py."""
    from mppi_gpu_tpu.ops import fused_rollout as fr

    T, a = U.shape
    plan = fr.plan_for(dyn, cost, K, T, a, antithetic=antithetic, ou_beta=ou_beta)
    words = fr.robot_words(key[None])
    rows = fr.pack_rows(dyn, cost, x0[None], sigma, plan)
    S_pad = fr.fused_costs(words, U[None], rows, plan, interpret=interpret)[0]
    # padded rollouts carry cost +inf: exp(-(inf-β)/λ) is exactly 0, so they
    # drop out of η and ΔU without masking here
    sm = softmin_weights(S_pad, lambda_, axis_name=axis_name)
    dU = fr.fused_update(words, rows, sm.weights[None], plan, interpret=interpret)[0]
    if axis_name is not None:
        dU = jax.lax.psum(dU, axis_name)
    u_new = U + dU
    if clamp:
        u_new = jnp.clip(u_new, -max_a, max_a)
    return SolveResult(
        action=u_new[0],
        u_next=shift_action_seq(u_new),
        info=SolveInfo(
            costs=S_pad[:K], beta=sm.beta, eta=sm.eta,
            weights=sm.weights[:K], u_seq=u_new,
        ),
    )


def resolve_backend(
    requested: str, dyn: Dynamics, cost: Cost, *, platform: str | None = None
) -> str:
    """'auto' → the fused kernels on a GPU when some fused family covers the
    (model, cost) pair — any of the eight registered families in
    ops.fused_rollout.FAMILIES: lti (point-mass + quadratic), lti-obstacle,
    pendulum, cartpole, quadrotor (planar), quadrotor3d, unicycle, arm
    (two-link manipulator) — else the generic XLA scan path (which handles
    arbitrary dynamics/costs, incl. MLP/hybrid models)."""
    if requested != "auto":
        return requested
    from mppi_gpu_tpu.ops import fused_rollout as fr

    try:
        fr.family_for(dyn, cost)
    except TypeError:
        return "scan"
    platform = platform or jax.default_backend()
    return "pallas" if platform == "gpu" else "scan"


class MPPIController:
    """Config-driven MPPI controller (the analog of the reference's
    `PointMassModel` host class, include/point_mass.hpp:23-116 — minus the
    manual buffer choreography, which jit makes obsolete).

    Usage:
        ctrl = MPPIController(load_config("configs/point_mass2d.yaml"))
        U = ctrl.init_action_seq()
        key = ctrl.init_key()
        action, U, info = ctrl.solve(x, U, key)   # jitted after first call
    """

    def __init__(
        self,
        cfg: MPPIConfig,
        dynamics: Dynamics | None = None,
        cost: Cost | None = None,
        *,
        rollout_backend: str = "auto",
        donate_u: bool = False,
        sampler: str = "auto",
    ) -> None:
        from mppi_gpu_tpu.models import dynamics_for_config

        self.cfg = cfg
        self.dynamics = dynamics if dynamics is not None else dynamics_for_config(cfg)
        self.cost = cost if cost is not None else make_cost(cfg)
        self.sigma = jnp.asarray(cfg.noise, jnp.float32)
        self.lambda_ = jnp.float32(cfg.lambda_)
        self.max_a = jnp.asarray(cfg.max_a, jnp.float32)
        rollout_backend = resolve_backend(rollout_backend, self.dynamics, self.cost)
        self.rollout_backend = rollout_backend
        # scan-path normal sampler (pallas backends sample in-kernel and
        # ignore this); "auto" → rbg here (unbatched context), see
        # _standard_normal_tiled for the vmap caveat
        self.sampler = sampler

        solve = partial(
            mppi_solve,
            K=cfg.samples,
            clamp=cfg.clamp_action,
            rollout_backend=rollout_backend,
            antithetic=cfg.antithetic,
            ou_beta=cfg.noise_beta,
            opt_iters=cfg.opt_iters,
            sampler=sampler,
        )
        donate = (3,) if donate_u else ()  # donate U's buffer (dyn, cost, x0, U, key,...)
        self._solve = jax.jit(solve, donate_argnums=donate)
        self._solve_det = jax.jit(
            partial(mppi_solve_deterministic, clamp=cfg.clamp_action)
        )

    # -- state helpers -----------------------------------------------------
    def init_action_seq(self) -> jax.Array:
        """U[t] = init-act for all t (the reference parses init-act but zeroes
        U instead, src/main.cu:678-684 — here the key is honored)."""
        return jnp.tile(
            jnp.asarray(self.cfg.init_act, jnp.float32)[None, :], (self.cfg.horizon, 1)
        )

    def init_key(self) -> jax.Array:
        return jax.random.key(self.cfg.seed)

    # -- solves ------------------------------------------------------------
    def solve(
        self, x: jax.Array, U: jax.Array, key: jax.Array
    ) -> SolveResult:
        """One control step. Split the key outside if you manage it manually,
        or use :meth:`solve_auto` which folds in a step counter."""
        return self._solve(
            self.dynamics, self.cost, x, U, key, self.sigma, self.lambda_, self.max_a
        )

    def solve_with_eps(self, x: jax.Array, U: jax.Array, eps: jax.Array) -> SolveResult:
        """Deterministic solve with injected noise (parity/testing)."""
        return self._solve_det(
            self.dynamics, self.cost, x, U, eps, self.lambda_, self.max_a
        )

    def solve_auto(
        self, x: jax.Array, U: jax.Array, key: jax.Array, step: int
    ) -> SolveResult:
        return self.solve(x, U, jax.random.fold_in(key, step))

    def solve_debug(
        self, x: jax.Array, U: jax.Array, key: jax.Array
    ) -> tuple[SolveResult, jax.Array, jax.Array]:
        """Solve that also materializes the sampled noise and full rollout
        trajectories — the data the reference's per-step debug dump exports
        for offline verification (src/point_mass.cu:236-262 `get_inf` +
        src/main.cu:90-156 `to_csv2`). Compiled separately so the hot path
        never pays for the (T+1, K, s) state history.

        FAITHFUL on every backend: for the scan backend the sampler
        reproduces `solve` exactly; for the pallas backends the solve runs
        through the SAME kernels as the hot path and the dump calls the
        kernels' counter-based generator outside them
        (ops.noise.noise_tensor) — the analog of the reference's ε buffer
        round-trip (src/point_mass_gpu.cu:123-129).
        Under iterated MPPI (cfg.opt_iters > 1) the dump documents the FINAL
        iteration — the solve whose action drives the robot — after
        replaying the first M-1 updates exactly as the hot path does."""
        if not hasattr(self, "_solve_debug"):
            from mppi_gpu_tpu.ops.rollout import rollout_trajectories

            backend = self.rollout_backend
            pallas = backend in ("pallas", "pallas-interpret")

            def dbg(dyn, cost, x, U, key, sigma, lambda_, max_a):
                T, a = U.shape
                M = self.cfg.opt_iters
                if M > 1:
                    # iterated MPPI: advance through the first M-1 updates
                    # exactly as the hot path does, then document the FINAL
                    # iteration — the one whose action drives the robot
                    def pre(Uc, j):
                        r = mppi_solve(
                            dyn, cost, x, Uc, jax.random.fold_in(key, j),
                            sigma, lambda_, max_a,
                            K=self.cfg.samples, clamp=self.cfg.clamp_action,
                            rollout_backend=backend,
                            antithetic=self.cfg.antithetic,
                            ou_beta=self.cfg.noise_beta,
                            sampler=self.sampler,
                        )
                        return r.info.u_seq, None

                    U, _ = jax.lax.scan(pre, U, jnp.arange(M - 1))
                    key = jax.random.fold_in(key, M - 1)
                if pallas:
                    res = mppi_solve(
                        dyn, cost, x, U, key, sigma, lambda_, max_a,
                        K=self.cfg.samples, clamp=self.cfg.clamp_action,
                        rollout_backend=backend,
                        antithetic=self.cfg.antithetic,
                        ou_beta=self.cfg.noise_beta,
                    )
                    eps = noise_tensor(
                        key, T, self.cfg.samples, a, sigma,
                        antithetic=self.cfg.antithetic,
                        ou_beta=self.cfg.noise_beta,
                    )
                    _, xs = rollout_trajectories(dyn, cost, x, U, eps)
                    return res, eps, xs
                eps = sample_noise(
                    key, T, self.cfg.samples, a, sigma,
                    antithetic=self.cfg.antithetic,
                    ou_beta=self.cfg.noise_beta,
                    sampler=self.sampler,
                )
                S, xs = rollout_trajectories(dyn, cost, x, U, eps)
                res = solve_from_costs(
                    S, eps, U, lambda_, max_a, clamp=self.cfg.clamp_action
                )
                return res, eps, xs

            self._solve_debug = jax.jit(dbg)
        return self._solve_debug(
            self.dynamics, self.cost, x, U, key, self.sigma, self.lambda_, self.max_a
        )
