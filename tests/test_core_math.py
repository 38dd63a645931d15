"""Core math vs the NumPy oracle: dynamics, cost, rollout, softmin, solve.

Mirrors the reference's kernel-unit-test pattern (src/test.cu: deterministic
inputs → CPU oracle → element-wise compare within tolerance, sweeping sizes to
hit edge cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.controller import (
    MPPIController,
    mppi_solve_deterministic,
    sample_noise,
    shift_action_seq,
)
from mppi_gpu_tpu.models.point_mass import PointMassLTI
from mppi_gpu_tpu.ops.cost import QuadraticCost, make_cost
from mppi_gpu_tpu.ops.rollout import rollout_costs, rollout_trajectories
from mppi_gpu_tpu.ops.softmin import softmin_weights

from oracle import oracle_lti_step, oracle_rollout_costs, oracle_solve

TOL = 1e-5  # float32 vs float64 oracle


def make_cfg(K=7, T=9, a=2, lam=1.3, clamp=True):
    return MPPIConfig(
        env="test", samples=K, state_dim=2 * a, action_dim=a, horizon=T,
        dt=0.1, lambda_=lam,
        noise=tuple([0.25] * a), init_act=tuple([0.05] * a),
        max_a=tuple([1.0] * a),
        goal=tuple([1.0] * a + [0.0] * a),
        cost_type="quadratic", cost_w=tuple([1.0] * a + [0.5] * a),
        clamp_action=clamp,
    )


def test_lti_step_matches_oracle(rng):
    for a in (1, 2, 3):
        dyn = PointMassLTI.create(0.1, a)
        x = rng.normal(size=(5, 2 * a)).astype(np.float32)
        u = rng.normal(size=(5, a)).astype(np.float32)
        got = np.asarray(dyn.step(jnp.asarray(x), jnp.asarray(u)))
        want = oracle_lti_step(x, u, 0.1)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quadratic_cost_matches_oracle(rng):
    a, s = 2, 4
    w = rng.uniform(0.1, 2.0, s)
    goal = rng.normal(size=s)
    inv_s = rng.uniform(0.5, 2.0, a)
    lam = 1.7
    cost = QuadraticCost(
        w=jnp.asarray(w, jnp.float32), goal=jnp.asarray(goal, jnp.float32),
        lambda_=jnp.float32(lam), inv_s=jnp.asarray(inv_s, jnp.float32),
    )
    x = rng.normal(size=(6, s))
    u = rng.normal(size=a)
    e = rng.normal(size=(6, a))
    got = np.asarray(cost.step(jnp.asarray(x, jnp.float32), jnp.asarray(u, jnp.float32), jnp.asarray(e, jnp.float32)))
    want = lam * (u[None] * inv_s[None] * e).sum(-1) + ((x - goal) ** 2 * w).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_f = np.asarray(cost.final(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got_f, ((x - goal) ** 2 * w).sum(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,T,a", [(1, 1, 1), (3, 12, 2), (17, 5, 3), (64, 50, 2)])
def test_rollout_costs_match_oracle(rng, K, T, a):
    """Size sweep hits the same edge cases the reference's test.cu sweeps for
    (n=1..59, t=1..99 block boundaries — the fused kernels' own block edges
    are tested in test_fused_rollout.py, but K=1/T=1 still matter)."""
    cfg = make_cfg(K=K, T=T, a=a)
    dyn = PointMassLTI.create(cfg.dt, a)
    cost = make_cost(cfg)
    x0 = rng.normal(size=2 * a).astype(np.float32)
    U = rng.normal(size=(T, a)).astype(np.float32) * 0.3
    eps = rng.normal(size=(T, K, a)).astype(np.float32) * 0.25

    got = np.asarray(rollout_costs(dyn, cost, jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps)))
    want = oracle_rollout_costs(
        x0, U, eps, cfg.dt, np.asarray(cfg.cost_w), np.asarray(cfg.goal),
        cfg.lambda_, np.ones(a),
    )
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_rollout_trajectories_consistent(rng):
    cfg = make_cfg(K=4, T=6, a=1)
    dyn = PointMassLTI.create(cfg.dt, 1)
    cost = make_cost(cfg)
    x0 = jnp.asarray(rng.normal(size=2), dtype=jnp.float32)
    U = jnp.asarray(rng.normal(size=(6, 1)), dtype=jnp.float32)
    eps = jnp.asarray(rng.normal(size=(6, 4, 1)), dtype=jnp.float32)
    S1 = rollout_costs(dyn, cost, x0, U, eps)
    S2, xs = rollout_trajectories(dyn, cost, x0, U, eps)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=1e-6)
    assert xs.shape == (7, 4, 2)
    np.testing.assert_allclose(np.asarray(xs[0]), np.tile(np.asarray(x0), (4, 1)))


def test_softmin_weights(rng):
    S = rng.uniform(0, 100, size=33)
    lam = 2.2
    res = softmin_weights(jnp.asarray(S, jnp.float32), jnp.float32(lam))
    beta = S.min()
    e = np.exp(-(S - beta) / lam)
    np.testing.assert_allclose(float(res.beta), beta, rtol=1e-6)
    np.testing.assert_allclose(float(res.eta), e.sum(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res.weights), e / e.sum(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.weights).sum(), 1.0, rtol=1e-5)


def test_shift_repeats_last():
    U = jnp.arange(12, dtype=jnp.float32).reshape(6, 2)
    got = np.asarray(shift_action_seq(U))
    assert (got[:-1] == np.asarray(U)[1:]).all()
    assert (got[-1] == np.asarray(U)[-1]).all()  # reference repeats U[T-1]


@pytest.mark.parametrize("clamp", [False, True])
def test_full_solve_matches_oracle(rng, clamp):
    cfg = make_cfg(K=25, T=14, a=2, lam=0.9, clamp=clamp)
    ctrl = MPPIController(cfg)
    x0 = rng.normal(size=4).astype(np.float32) * 0.2
    U = rng.normal(size=(14, 2)).astype(np.float32) * 2.0  # big enough to clamp
    eps = rng.normal(size=(14, 25, 2)).astype(np.float32) * 0.25

    res = ctrl.solve_with_eps(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(eps))

    S, U_new, action, U_shift, wgt, beta, eta = oracle_solve(
        x0, U, eps, cfg.dt, np.asarray(cfg.cost_w), np.asarray(cfg.goal),
        cfg.lambda_, np.ones(2), max_a=np.asarray(cfg.max_a) if clamp else None,
    )
    np.testing.assert_allclose(np.asarray(res.info.costs), S, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(res.info.beta), beta, rtol=TOL)
    np.testing.assert_allclose(float(res.info.eta), eta, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(res.info.weights), wgt, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.info.u_seq), U_new, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.action), action, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.u_next), U_shift, rtol=1e-4, atol=1e-5)
    if clamp:
        assert np.abs(np.asarray(res.u_next)).max() <= 1.0 + 1e-6


def test_stochastic_solve_statistics():
    """Distribution-level check: sampled noise has the configured per-dim std,
    and the solve is deterministic given the key."""
    key = jax.random.key(0)
    sigma = jnp.asarray([0.1, 0.4], jnp.float32)
    eps = sample_noise(key, 100, 2000, 2, sigma)
    stds = np.asarray(eps).std(axis=(0, 1))
    np.testing.assert_allclose(stds, [0.1, 0.4], rtol=0.05)

    cfg = make_cfg(K=64, T=10, a=2)
    ctrl = MPPIController(cfg)
    x0 = jnp.zeros(4)
    U = ctrl.init_action_seq()
    r1 = ctrl.solve(x0, U, key)
    r2 = ctrl.solve(x0, U, key)
    np.testing.assert_array_equal(np.asarray(r1.action), np.asarray(r2.action))


def test_solve_reduces_expected_cost():
    """Sanity: iterating solves from rest should steer the 1D point mass
    toward the goal (controller-internal model)."""
    cfg = make_cfg(K=512, T=30, a=1)
    ctrl = MPPIController(cfg)
    dyn = ctrl.dynamics
    key = jax.random.key(1)
    x = jnp.zeros(2)
    U = ctrl.init_action_seq()
    for step in range(40):
        res = ctrl.solve_auto(x, U, key, step)
        x = dyn.step(x, res.action)
        U = res.u_next
    # goal is q=1, qd=0
    assert abs(float(x[0]) - 1.0) < 0.2, f"final state {x}"


# ---------------------------------------------------------------------------
# Tiled SoA scan layout (round 4): the production scan path pads K up to
# whole (8, 128) tiles and runs rollouts on the (sublane, lane) axes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("anti", [False, True])
def test_tiled_scan_solve_matches_flat_oracle(anti):
    """ctrl.solve on the scan backend (tiled layout) must equal the flat
    deterministic solve fed sample_noise's flat view of the SAME stream —
    including the padded-rollout masking and the antithetic mirror-half
    ordering of SolveInfo."""
    cfg = make_cfg(K=70, T=9, a=2).replace(antithetic=anti)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    x = jnp.asarray([0.3, -0.1, 0.05, 0.2], jnp.float32)
    U = ctrl.init_action_seq() + 0.02
    key = jax.random.key(11)
    res = ctrl.solve(x, U, key)

    eps = sample_noise(
        key, cfg.horizon, cfg.samples, cfg.action_dim, ctrl.sigma,
        antithetic=anti,
    )
    assert eps.shape == (cfg.horizon, cfg.samples, cfg.action_dim)
    ref = mppi_solve_deterministic(
        ctrl.dynamics, ctrl.cost, x, U, eps, ctrl.lambda_, ctrl.max_a,
        clamp=cfg.clamp_action,
    )
    np.testing.assert_allclose(
        np.asarray(res.action), np.asarray(ref.action), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.u_next), np.asarray(ref.u_next), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.info.costs), np.asarray(ref.info.costs), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.info.weights), np.asarray(ref.info.weights),
        rtol=1e-4, atol=1e-8,
    )
    np.testing.assert_allclose(
        float(res.info.beta), float(ref.info.beta), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(res.info.weights.sum()), 1.0, rtol=1e-5
    )


def test_tiled_rollout_matches_flat_rollout_nonlinear():
    """rollout_costs_tiled == rollout_costs on identical noise for a
    nonlinear (trig) model — the per-sample double-vmap contract."""
    from mppi_gpu_tpu.models.pendulum import PendulumDynamics
    from mppi_gpu_tpu.ops.cost import PendulumSwingupCost
    from mppi_gpu_tpu.ops.rollout import LANE, rollout_costs_tiled

    dyn = PendulumDynamics.create(0.05)
    cost = PendulumSwingupCost(
        w_angle=jnp.float32(4.0), w_vel=jnp.float32(0.2),
        lambda_=jnp.float32(1.0), inv_s=jnp.asarray([1.0]),
    )
    T, R = 12, 16  # R*LANE = 2048 rollouts
    x0 = jnp.asarray([3.0, 0.1], jnp.float32)
    U = 0.1 * jnp.ones((T, 1), jnp.float32)
    eps = 0.8 * jax.random.normal(jax.random.key(3), (T, 1, R, LANE), jnp.float32)
    S_tiled = rollout_costs_tiled(dyn, cost, x0, U, eps)
    assert S_tiled.shape == (R, LANE)
    eps_flat = jnp.swapaxes(eps.reshape(T, 1, R * LANE), 1, 2)
    S_flat = rollout_costs(dyn, cost, x0, U, eps_flat)
    np.testing.assert_allclose(
        np.asarray(S_tiled.reshape(-1)), np.asarray(S_flat), rtol=2e-5
    )


def test_flat_layout_escape_hatch(monkeypatch):
    """MPPI_SCAN_LAYOUT=flat restores the pre-round-4 flat scan path."""
    monkeypatch.setenv("MPPI_SCAN_LAYOUT", "flat")
    cfg = make_cfg(K=33, T=7, a=1)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    x = jnp.zeros(2)
    res = ctrl.solve(x, ctrl.init_action_seq(), jax.random.key(0))
    assert np.all(np.isfinite(np.asarray(res.action)))
    np.testing.assert_allclose(float(res.info.weights.sum()), 1.0, rtol=1e-5)


def test_tiled_sampler_moments_and_switch(monkeypatch):
    """Both tiled samplers are sound standard normals (moments, symmetry,
    tail mass); MPPI_SCAN_SAMPLER=boxmuller swaps in the (measured-slower,
    see _standard_normal_tiled) Box-Muller stream — different draws, same
    distribution."""
    from mppi_gpu_tpu.controller import _standard_normal_tiled

    shape = (50, 2, 16, 128)  # 204k draws
    monkeypatch.setenv("MPPI_SCAN_SAMPLER", "boxmuller")
    x = np.asarray(_standard_normal_tiled(jax.random.key(0), shape)).ravel()
    assert abs(x.mean()) < 0.01
    assert abs(x.std() - 1.0) < 0.01
    assert abs(np.mean(x**3)) < 0.03            # symmetry
    assert abs(np.mean(np.abs(x) > 1.96) - 0.05) < 0.005  # tail mass
    assert np.abs(x).max() < 6.0

    monkeypatch.delenv("MPPI_SCAN_SAMPLER")     # default: erfinv
    y = np.asarray(_standard_normal_tiled(jax.random.key(0), shape)).ravel()
    assert abs(y.std() - 1.0) < 0.01
    assert not np.allclose(x[:100], y[:100])  # genuinely different streams
