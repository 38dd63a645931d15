"""Batched multi-robot controller: each robot's solve must equal the
single-robot solve with the same key, and per-robot goals must steer each
robot toward its own target."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mppi_gpu_tpu.batched import BatchedMPPIController
from mppi_gpu_tpu.config import load_config
from mppi_gpu_tpu.controller import MPPIController

CFG = "configs/mppi-config-test.yaml"


def test_batched_matches_single():
    cfg = load_config(CFG)
    B = 3
    ctrl_b = BatchedMPPIController(cfg, B)
    # the fleet resolves "auto" to the vmap-exact erfinv sampler (rbg is not
    # vmap-elementwise); the single-robot twin must match it for bit parity
    ctrl_1 = MPPIController(cfg, rollout_backend="scan", sampler="erfinv")

    xs = jnp.stack([jnp.full((cfg.state_dim,), 0.1 * i) for i in range(B)])
    Us = ctrl_b.init_action_seqs()
    keys = ctrl_b.init_keys()
    res_b = ctrl_b.solve_batch(xs, Us, keys)
    assert res_b.action.shape == (B, cfg.action_dim)
    assert res_b.info.costs.shape == (B, cfg.samples)

    for i in range(B):
        res_1 = ctrl_1.solve(xs[i], Us[i], keys[i])
        np.testing.assert_allclose(
            np.asarray(res_b.action[i]), np.asarray(res_1.action), rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(res_b.u_next[i]), np.asarray(res_1.u_next), rtol=1e-5, atol=1e-6
        )


def test_per_robot_goals_steer_apart():
    cfg = load_config("configs/point_mass1d.yaml").replace(samples=256, horizon=20)
    B = 2
    goals = jnp.asarray([[1.0, 0.0], [-1.0, 0.0]])
    ctrl = BatchedMPPIController(cfg, B, goals=goals)
    xs = jnp.zeros((B, cfg.state_dim))
    res = ctrl.solve_batch(xs, ctrl.init_action_seqs(), ctrl.init_keys())
    # robot 0 pushes toward +1, robot 1 toward −1
    assert float(res.action[0, 0]) > 0.05
    assert float(res.action[1, 0]) < -0.05


def test_per_robot_goals_quadrotor_fleet():
    """Per-robot goals generalize past the quadratic cost: a quadrotor
    fleet with one robot targeting +x and one −x splits its differential
    commands accordingly (robots start level at the origin, so the tilt
    decision is the first observable difference)."""
    cfg = load_config("configs/quadrotor.yaml").replace(samples=256, horizon=30)
    B = 2
    goals = jnp.asarray(
        [[2.0, 0.0, 0.0, 0.0, 0.0, 0.0], [-2.0, 0.0, 0.0, 0.0, 0.0, 0.0]]
    )
    ctrl = BatchedMPPIController(cfg, B, goals=goals)
    xs = jnp.zeros((B, cfg.state_dim))
    res = ctrl.solve_batch(xs, ctrl.init_action_seqs(), ctrl.init_keys())
    # +x needs theta > 0 (right tip down) => positive differential D, and
    # vice versa; compare the early-horizon mean D per robot
    D0 = float(jnp.mean(res.u_next[0, :10, 1]))
    D1 = float(jnp.mean(res.u_next[1, :10, 1]))
    assert D0 > D1, (D0, D1)


def test_per_robot_goals_obstacle_cost():
    """The obstacle cost wraps its quadratic goal in `base` — per-robot
    goals must reach through the wrapper."""
    cfg = load_config("configs/point_mass1d.yaml").replace(
        samples=256, horizon=20, cost_type="obstacle",
        obstacles=((5.0, 0.5),),  # (x, radius) far away: behaves like plain quadratic
    )
    goals = jnp.asarray([[1.0, 0.0], [-1.0, 0.0]])
    ctrl = BatchedMPPIController(cfg, 2, goals=goals)
    res = ctrl.solve_batch(
        jnp.zeros((2, cfg.state_dim)), ctrl.init_action_seqs(), ctrl.init_keys()
    )
    assert float(res.action[0, 0]) > 0.05
    assert float(res.action[1, 0]) < -0.05


def test_per_robot_goals_rejected_for_builtin_target_costs():
    import pytest

    cfg = load_config("configs/pendulum.yaml").replace(samples=64, horizon=10)
    with pytest.raises(TypeError, match="goal"):
        BatchedMPPIController(cfg, 2, goals=jnp.zeros((2, 2)))


# ---------------------------------------------------------------------------
# Fleet fused kernels (pallas backend): grid axis 0 = robot axis


def _fleet_vs_single_pallas(cfg, B, goals=None):
    """Fleet kernels (robot = grid axis 0) vs per-robot references with the
    same keys: the single-robot pallas controller, and the deterministic
    scan solve fed each robot's ε from the shared generator."""
    import dataclasses as dc

    from mppi_gpu_tpu.controller import mppi_solve_deterministic
    from mppi_gpu_tpu.ops.noise import noise_tensor

    ctrl_b = BatchedMPPIController(
        cfg, B, goals=goals, rollout_backend="pallas-interpret"
    )
    xs = jnp.stack([jnp.full((cfg.state_dim,), 0.05 * i) for i in range(B)])
    if cfg.state_dim == 13:  # quadrotor3d: states need a unit quaternion
        q = jnp.asarray([1.0, 0.0, 0.0, 0.0])
        xs = jax.vmap(lambda x: x.at[3:7].set(q))(xs)
    Us = ctrl_b.init_action_seqs()
    keys = ctrl_b.init_keys()
    res_b = ctrl_b.solve_batch(xs, Us, keys)
    assert res_b.action.shape == (B, cfg.action_dim)
    assert res_b.info.costs.shape == (B, cfg.samples)

    for i in range(B):
        cost_i = ctrl_b.cost
        if goals is not None:
            cost_i = (dc.replace(cost_i, goal=goals[i]) if hasattr(cost_i, "goal")
                      else dc.replace(cost_i, base=dc.replace(cost_i.base, goal=goals[i])))
        ctrl_1 = MPPIController(cfg, cost=cost_i, rollout_backend="pallas-interpret")
        res_1 = ctrl_1.solve(xs[i], Us[i], keys[i])
        # (reference, tolerance on actions): the same kernels exactly; the
        # scan solve within the softmin's amplification (1/λ) of the
        # kernels' small-angle trig-carry rounding in S
        refs = [(res_1, 1e-4)]
        if cfg.opt_iters == 1:
            eps = noise_tensor(keys[i], cfg.horizon, cfg.samples, cfg.action_dim,
                               ctrl_b.sigma, antithetic=cfg.antithetic,
                               ou_beta=cfg.noise_beta)
            refs.append((mppi_solve_deterministic(
                ctrl_b.dynamics, cost_i, xs[i], Us[i], eps,
                ctrl_b.lambda_, ctrl_b.max_a, clamp=cfg.clamp_action,
            ), 1e-3))
        for ref, tol in refs:
            np.testing.assert_allclose(
                np.asarray(res_b.action[i]), np.asarray(ref.action),
                rtol=tol, atol=1e-6,
            )
            np.testing.assert_allclose(
                np.asarray(res_b.u_next[i]), np.asarray(ref.u_next),
                rtol=tol, atol=1e-6,
            )
            np.testing.assert_allclose(
                np.asarray(res_b.info.costs[i]), np.asarray(ref.info.costs),
                rtol=1e-4,
            )


def test_fleet_pallas_matches_single_pallas():
    cfg = load_config(CFG)
    _fleet_vs_single_pallas(cfg, B=3)


def test_fleet_pallas_per_robot_goals():
    cfg = load_config("configs/point_mass2d.yaml").replace(samples=300, horizon=15)
    goals = jnp.asarray([[1.0, 0.5, 0.0, 0.0], [-0.5, 1.0, 0.0, 0.0]])
    _fleet_vs_single_pallas(cfg, B=2, goals=goals)


def test_fleet_pallas_quadrotor3d():
    """Largest family through the fleet kernels: A=4, 13 state vectors.
    opt_iters pinned to 1 (the yaml ships opt-iters 2): the subject is the
    fleet kernels vs the per-robot references, and the iterated fleet path
    has its own test (test_opt_iters_fleet_pallas...)."""
    cfg = load_config("configs/quadrotor3d.yaml").replace(
        samples=300, horizon=10, opt_iters=1
    )
    _fleet_vs_single_pallas(cfg, B=2)


def test_fleet_pallas_arm():
    """Eighth family through the fleet kernels: configuration-dependent
    mass matrix + the carried-trig step."""
    cfg = load_config("configs/arm.yaml").replace(
        samples=300, horizon=10, noise_beta=0.0, opt_iters=1
    )
    _fleet_vs_single_pallas(cfg, B=2)


def test_fleet_pallas_antithetic_and_ou():
    cfg = load_config(CFG).replace(samples=64, antithetic=True, noise_beta=0.5)
    _fleet_vs_single_pallas(cfg, B=2)


def test_fleet_pallas_planar_matches_oracle(rng):
    """A=3 lti fleet with random per-robot goals and states: every robot
    matches the scan solve fed its ε from the shared generator."""
    import dataclasses as dc

    from mppi_gpu_tpu.config import MPPIConfig
    from mppi_gpu_tpu.controller import mppi_solve_deterministic
    from mppi_gpu_tpu.ops.noise import noise_tensor

    R, K, T, A = 3, 260, 9, 3
    cfg = MPPIConfig(
        env="t", samples=K, state_dim=2 * A, action_dim=A, horizon=T, dt=0.1,
        lambda_=1.0, noise=(0.25,) * A, init_act=(0.0,) * A, max_a=(1.0,) * A,
        goal=(1.0,) * A + (0.0,) * A, cost_type="quadratic",
        cost_w=(1.0,) * A + (0.5,) * A,
    )
    goals = jnp.asarray(rng.normal(size=(R, 2 * A)), jnp.float32)
    fleet = BatchedMPPIController(
        cfg, R, goals=goals, rollout_backend="pallas-interpret"
    )
    xs = jnp.asarray(rng.normal(size=(R, 2 * A)) * 0.3, jnp.float32)
    Us = fleet.init_action_seqs()
    keys = fleet.init_keys()
    res = fleet.solve_batch(xs, Us, keys)
    assert res.u_next.shape == (R, T, A)
    sigma = jnp.asarray(cfg.noise, jnp.float32)
    base_cost = MPPIController(cfg, rollout_backend="scan").cost
    for r in range(R):
        eps = noise_tensor(keys[r], T, K, A, sigma)
        cost_r = dc.replace(base_cost, goal=goals[r])
        ref = mppi_solve_deterministic(
            fleet.dynamics, cost_r, xs[r], Us[r], eps,
            fleet.lambda_, fleet.max_a, clamp=cfg.clamp_action,
        )
        np.testing.assert_allclose(
            np.asarray(res.u_next[r]), np.asarray(ref.u_next), rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(res.info.costs[r]), np.asarray(ref.info.costs), rtol=3e-5
        )
