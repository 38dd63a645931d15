"""Two-link arm family: manipulator dynamics with a configuration-dependent
mass matrix, end-effector reach cost, eighth world — exercises every
extension seam (model registry, cost registry, env dispatch, runner,
fused-family registry) plus the joint-rate saturation that keeps the stiff
RK2 step finite under extreme torque noise."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.config import load_config
from mppi_gpu_tpu.controller import MPPIController
from mppi_gpu_tpu.envs import make_jax_world, params_for_config
from mppi_gpu_tpu.envs.arm_world import ArmParams, ArmWorld
from mppi_gpu_tpu.models import dynamics_for_config
from mppi_gpu_tpu.models.arm import TwoLinkArmDynamics
from mppi_gpu_tpu.runner import run_closed_loop

CFG = "configs/arm.yaml"
TARGET = np.array([0.55, 0.35])


def test_dispatch_selects_arm():
    cfg = load_config(CFG)
    assert isinstance(dynamics_for_config(cfg), TwoLinkArmDynamics)
    assert isinstance(params_for_config(cfg), ArmParams)
    assert isinstance(make_jax_world(cfg), ArmWorld)
    cfg_pm = load_config("configs/point_mass2d.yaml")
    assert not isinstance(dynamics_for_config(cfg_pm), TwoLinkArmDynamics)


def test_dynamics_physics():
    dyn = TwoLinkArmDynamics.create(0.002, damping=0.0)
    # hanging straight down is an equilibrium: zero gravity moment on both
    # joints (links along -y), so the state must not move without torque
    x = jnp.asarray([-np.pi / 2, 0.0, 0.0, 0.0], jnp.float32)
    for _ in range(200):
        x = dyn.step(x, jnp.zeros(2))
    np.testing.assert_allclose(
        np.asarray(x), [-np.pi / 2, 0.0, 0.0, 0.0], atol=1e-5
    )
    # passive swing from horizontal conserves energy (no damping): after
    # 0.8 s of free fall + swing, E = T + U must match the initial energy
    def energy(dyn, x):
        q1, q2, qd1, qd2 = (float(v) for v in x)
        # T = 1/2 q̇ᵀ M q̇ with the same closed-form M
        c2 = np.cos(q2)
        d11 = float(dyn.A) + 2 * float(dyn.B) * c2
        d12 = float(dyn.D) + float(dyn.B) * c2
        d22 = float(dyn.D)
        T = 0.5 * (d11 * qd1**2 + 2 * d12 * qd1 * qd2 + d22 * qd2**2)
        # U from the same G1/G2 constants: U = G1 sin q1 + G2 sin(q1+q2)
        U = float(dyn.G1) * np.sin(q1) + float(dyn.G2) * np.sin(q1 + q2)
        return T + U

    x = jnp.asarray([0.0, 0.3, 0.0, 0.0], jnp.float32)
    e0 = energy(dyn, x)
    for _ in range(400):
        x = dyn.step(x, jnp.zeros(2))
    assert abs(energy(dyn, x) - e0) < 0.02 * abs(e0) + 0.02, (
        energy(dyn, x), e0,
    )
    # rate saturation: an absurd torque cannot push |qd| past max_rate
    dyn_s = TwoLinkArmDynamics.create(0.05)
    x = jnp.zeros(4)
    for _ in range(50):
        x = dyn_s.step(x, jnp.asarray([500.0, 300.0]))
    assert float(jnp.max(jnp.abs(x[2:]))) <= float(dyn_s.max_rate) + 1e-5
    assert bool(jnp.all(jnp.isfinite(x)))


def test_end_effector_kinematics():
    dyn = TwoLinkArmDynamics.create(0.01)
    # straight out along +x
    np.testing.assert_allclose(
        np.asarray(dyn.end_effector(jnp.zeros(4))), [1.0, 0.0], atol=1e-6
    )
    # shoulder up, elbow 90°: ee at (−l2? no): q1=π/2, q2=−π/2 → link1 up,
    # link2 along +x
    x = jnp.asarray([np.pi / 2, -np.pi / 2, 0.0, 0.0], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(dyn.end_effector(x)), [0.5, 0.5], atol=1e-6
    )


def test_world_matches_model_per_step():
    """Same equations (the world calls the model's _deriv), different
    integrators (RK2 @ dt vs RK4 @ dt/~3). The arm is a double pendulum —
    chaotic, so accumulated trajectories diverge by design; the honest
    oracle is LOCAL truncation: one model step vs the fine-RK4 world over
    the same interval, from many random states."""
    cfg = load_config(CFG)
    dyn = TwoLinkArmDynamics.create(cfg.dt)
    # test-local world whose timestep divides dt EXACTLY (dt/4), so `sub`
    # fine-RK4 steps cover precisely the model step's interval — the shipped
    # default (0.005) gives round(3.33)=3 steps covering only 0.015 s, a
    # ~10% interval mismatch that would contaminate the truncation gap
    world = ArmWorld(ArmParams(timestep=float(cfg.dt) / 4.0))
    sub = int(round(cfg.dt / world.params.timestep))
    assert abs(sub * world.params.timestep - cfg.dt) < 1e-9
    rng = np.random.default_rng(5)
    pos_gaps, rate_gaps = [], []
    for _ in range(40):
        x = jnp.asarray(
            rng.uniform([-3, -3, -4, -4], [3, 3, 4, 4]), jnp.float32
        )
        u = jnp.asarray(rng.uniform(-5.0, 5.0, size=2), jnp.float32)
        x_model = np.asarray(dyn.step(x, u))
        s = world.from_x(x, 0.0)
        for _ in range(sub):
            s = world.physics_step(s, u)
        x_world = np.asarray(world.get_x(s))
        pos_gaps.append(np.abs(x_model[:2] - x_world[:2]).max())
        rate_gaps.append(np.abs(x_model[2:] - x_world[2:]).max())
    pos_gaps, rate_gaps = np.asarray(pos_gaps), np.asarray(rate_gaps)
    # typically-tight, worst-case-bounded: the gap is genuinely large at the
    # stiffest sampled states (folded arm near the mass-matrix minimum with
    # |qd| ~ 4) — that IS the mismatch the miss harness measures; a per-
    # sample tolerance would just re-tune itself to the worst draw
    assert np.median(pos_gaps) < 1e-2, np.median(pos_gaps)
    assert pos_gaps.max() < 0.05, pos_gaps.max()
    assert np.median(rate_gaps) < 0.1, np.median(rate_gaps)
    assert rate_gaps.max() < 0.5, rate_gaps.max()


@pytest.mark.slow
def test_reach_task():
    """Closed loop lifts the arm from hanging to the reach target against
    gravity and hovers there (MPPI is stochastic — assert the steady-state
    MEAN end-effector distance over the last 80 cycles, not one instant)."""
    cfg = load_config(CFG).replace(samples=512)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    res = run_closed_loop(ctrl, world_backend="jax", max_steps=300)
    dyn = TwoLinkArmDynamics.create(cfg.dt)
    ee = np.asarray(dyn.end_effector(jnp.asarray(res.xs[-80:])))
    ds = np.hypot(ee[:, 0] - TARGET[0], ee[:, 1] - TARGET[1])
    assert ds.mean() < 0.3, f"steady-state mean dist {ds.mean():.3f}"
    assert ds.min() < 0.15, f"never got close: min dist {ds.min():.3f}"
    us = np.asarray(res.us)
    assert np.all(np.abs(us[:, 0]) <= cfg.max_a[0] + 1e-5)
    assert np.all(np.abs(us[:, 1]) <= cfg.max_a[1] + 1e-5)


def test_checkpoint_roundtrip():
    cfg = load_config(CFG)
    world = make_jax_world(cfg)
    s = world.reset()
    s = world.physics_step(s, jnp.asarray([3.0, -1.0]))
    x = world.get_x(s)
    s2 = world.from_x(x, float(s.time))
    np.testing.assert_allclose(np.asarray(world.get_x(s2)), np.asarray(x))


def test_no_native_twin_but_mujoco_works():
    """The arm has no native C++ twin (clean error), but the real-MuJoCo
    plant IS wired (cross-validated in test_mujoco_xval) and a short
    closed loop runs against it."""
    cfg = load_config(CFG)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    with pytest.raises(ValueError, match="arm family"):
        run_closed_loop(ctrl, world_backend="native", max_steps=1)
    pytest.importorskip("mujoco")
    cfg_s = cfg.replace(samples=128, horizon=10)
    res = run_closed_loop(
        MPPIController(cfg_s, rollout_backend="scan"),
        world_backend="mujoco", max_steps=5,
    )
    assert np.all(np.isfinite(res.xs))


# --- fused family (kernels in interpret mode vs the scan reference)


def _setup_arm(T=10, K=280):
    from mppi_gpu_tpu.ops.cost import ArmReachCost

    dyn = TwoLinkArmDynamics.create(1.0 / 60.0)
    cost = ArmReachCost(
        w=jnp.asarray([20.0, 0.05]),
        goal=jnp.asarray([0.55, 0.35, 0.0, 0.0]),
        lambda_=jnp.float32(0.1), inv_s=jnp.asarray([1.0, 0.7]),
    )
    x0 = jnp.asarray([-1.2, 0.4, 0.5, -0.3])
    t = jnp.arange(T, dtype=jnp.float32)
    U = jnp.stack([4.0 + 2.0 * jnp.sin(0.3 * t), 1.5 * jnp.cos(0.5 * t)], axis=1)
    sigma = jnp.asarray([2.0, 1.0])
    return dyn, cost, x0, U, sigma


def test_arm_fused_family_matches_oracle():
    """Kernels A/B vs the scan reference fed the same ε (interpreted)."""
    from fused_check import check_against_reference

    from mppi_gpu_tpu.ops import fused_rollout as fr

    K, T = 280, 10
    dyn, cost, x0, U, sigma = _setup_arm(T, K)
    assert fr.family_for(dyn, cost) == "arm"
    check_against_reference(dyn, cost, x0, U, sigma, K=K, key=jax.random.key(13), lam=0.4)


def test_arm_fused_uses_cost_link_lengths():
    """The kernel's FK link lengths must come from the COST, not the
    dynamics: a user who builds TwoLinkArmDynamics.create(dt, l1=.., l2=..)
    with a default-length ArmReachCost must get the SAME costs on
    backend='pallas' as on 'scan'."""
    from fused_check import check_against_reference

    from mppi_gpu_tpu.ops.cost import ArmReachCost

    K, T = 280, 8
    # dynamics lengths ≠ cost lengths (cost keeps its 0.5 defaults)
    dyn = TwoLinkArmDynamics.create(1.0 / 60.0, l1=0.8, l2=0.3)
    cost = ArmReachCost(
        w=jnp.asarray([20.0, 0.05]),
        goal=jnp.asarray([0.55, 0.35, 0.0, 0.0]),
        lambda_=jnp.float32(0.1), inv_s=jnp.asarray([1.0, 0.7]),
    )
    x0 = jnp.asarray([-1.2, 0.4, 0.5, -0.3])
    t = jnp.arange(T, dtype=jnp.float32)
    U = jnp.stack([4.0 + 2.0 * jnp.sin(0.3 * t), 1.5 * jnp.cos(0.5 * t)], axis=1)
    check_against_reference(dyn, cost, x0, U, jnp.asarray([2.0, 1.0]), K=K,
                            key=jax.random.key(7))


def test_arm_controller_pallas_interpret_end_to_end():
    """MPPIController drives the arm through the REAL fused dispatch path
    (pallas-interpret): finite, clamped, weights sum to 1."""
    cfg = load_config(CFG).replace(samples=128, horizon=12)
    ctrl = MPPIController(cfg, rollout_backend="pallas-interpret")
    x = jnp.asarray([-1.5707963, 0.0, 0.0, 0.0], jnp.float32)
    res = ctrl.solve(x, ctrl.init_action_seq(), ctrl.init_key())
    assert bool(jnp.all(jnp.isfinite(res.action)))
    assert float(jnp.abs(res.info.u_seq).max()) <= cfg.max_a[0] + 1e-5
    np.testing.assert_allclose(float(res.info.weights.sum()), 1.0, rtol=1e-4)
