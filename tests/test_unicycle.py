"""Unicycle family: differential-drive kinematics, wrap-safe waypoint cost,
seventh world — the first family whose state dim (3) is not 2·action_dim,
exercising every extension seam (model registry, cost registry, env
dispatch, runner, fused-family registry)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.config import load_config
from mppi_gpu_tpu.controller import MPPIController
from mppi_gpu_tpu.envs import make_jax_world, params_for_config
from mppi_gpu_tpu.envs.unicycle_world import UnicycleParams, UnicycleWorld
from mppi_gpu_tpu.models import dynamics_for_config
from mppi_gpu_tpu.models.unicycle import UnicycleDynamics
from mppi_gpu_tpu.runner import run_closed_loop

CFG = "configs/unicycle.yaml"


def test_dispatch_selects_unicycle():
    cfg = load_config(CFG)
    assert isinstance(dynamics_for_config(cfg), UnicycleDynamics)
    assert isinstance(params_for_config(cfg), UnicycleParams)
    assert isinstance(make_jax_world(cfg), UnicycleWorld)
    cfg_pm = load_config("configs/point_mass2d.yaml")
    assert not isinstance(dynamics_for_config(cfg_pm), UnicycleDynamics)


def test_dynamics_physics():
    dyn = UnicycleDynamics.create(0.01)
    # straight line at heading 0: x advances by v*t, y and θ unchanged
    x = jnp.zeros(3)
    for _ in range(100):
        x = dyn.step(x, jnp.asarray([1.0, 0.0]))
    np.testing.assert_allclose(float(x[0]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(x[1]), 0.0, atol=1e-7)
    # pure rotation: pose fixed, heading advances by ω·t
    x = jnp.zeros(3)
    for _ in range(100):
        x = dyn.step(x, jnp.asarray([0.0, 0.5]))
    np.testing.assert_allclose(float(x[2]), 0.5, rtol=1e-5)
    np.testing.assert_allclose(float(x[0]), 0.0, atol=1e-6)
    # constant (v, ω) traces a circle of radius v/ω: after ω·t = 2π the
    # robot returns to the start (RK2 midpoint is exact for the heading,
    # near-exact for the arc at small steps)
    v, w, T = 1.0, 1.0, 2.0 * np.pi
    n = int(T / 0.01)
    x = jnp.zeros(3)
    for _ in range(n):
        x = dyn.step(x, jnp.asarray([v, w]))
    assert float(jnp.hypot(x[0], x[1])) < 5e-3


def test_world_matches_model_open_loop():
    """Same kinematics, different integrators (RK2 @ dt vs RK4 @ dt/10):
    short open-loop trajectories agree closely."""
    cfg = load_config(CFG)
    dyn = UnicycleDynamics.create(cfg.dt)
    world = make_jax_world(cfg)
    s = world.reset()
    x = world.get_x(s)
    rng = np.random.default_rng(3)
    for i in range(30):
        u = jnp.asarray(rng.uniform(-1.0, 1.0, size=2), jnp.float32)
        x = dyn.step(x, u)
        for _ in range(int(round(cfg.dt / world.params.timestep))):
            s = world.physics_step(s, u)
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(world.get_x(s)), rtol=1e-3, atol=2e-3
    )


def test_waypoint_navigation():
    """Closed loop drives the robot from the origin to the (2, 1) waypoint."""
    cfg = load_config(CFG).replace(samples=512)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    res = run_closed_loop(ctrl, world_backend="jax", max_steps=150)
    p = np.asarray(res.xs[-1])
    d = float(np.hypot(p[0] - 2.0, p[1] - 1.0))
    assert d < 0.25, f"did not reach the waypoint: final pose {p}, dist {d:.3f}"
    assert np.all(np.abs(np.asarray(res.us)[:, 0]) <= cfg.max_a[0] + 1e-6)
    assert np.all(np.abs(np.asarray(res.us)[:, 1]) <= cfg.max_a[1] + 1e-6)


def test_checkpoint_roundtrip():
    """from_x inverts get_x (the checkpoint/resume seam every world has)."""
    cfg = load_config(CFG)
    world = make_jax_world(cfg)
    s = world.reset()
    s = world.physics_step(s, jnp.asarray([0.7, -0.4]))
    x = world.get_x(s)
    s2 = world.from_x(x, float(s.time))
    np.testing.assert_allclose(np.asarray(world.get_x(s2)), np.asarray(x))


# --- fused family (kernels in interpret mode vs the scan reference)


def _setup_unicycle(T=12, K=300):
    from mppi_gpu_tpu.ops.cost import UnicycleWaypointCost

    dyn = UnicycleDynamics.create(0.05)
    cost = UnicycleWaypointCost(
        w=jnp.asarray([4.0, 1.0]), goal=jnp.asarray([2.0, 1.0, 0.0]),
        lambda_=jnp.float32(0.3), inv_s=jnp.asarray([1.0, 0.6]),
    )
    x0 = jnp.asarray([0.1, -0.2, 0.4])
    t = jnp.arange(T, dtype=jnp.float32)
    U = jnp.stack([0.8 + 0.2 * jnp.sin(0.3 * t), 0.3 * jnp.cos(0.4 * t)], axis=1)
    sigma = jnp.asarray([0.6, 1.0])
    return dyn, cost, x0, U, sigma


def test_unicycle_fused_family_matches_oracle():
    """Kernels A/B vs the scan reference fed the same ε (interpreted)."""
    from fused_check import check_against_reference

    from mppi_gpu_tpu.ops import fused_rollout as fr

    K, T = 300, 12
    dyn, cost, x0, U, sigma = _setup_unicycle(T, K)
    assert fr.family_for(dyn, cost) == "unicycle"
    check_against_reference(dyn, cost, x0, U, sigma, K=K, key=jax.random.key(11))


def test_auto_backend_covers_unicycle():
    from mppi_gpu_tpu.controller import resolve_backend
    from mppi_gpu_tpu.ops.cost import make_cost

    cfg = load_config(CFG)
    dyn, cost = dynamics_for_config(cfg), make_cost(cfg)
    assert resolve_backend("auto", dyn, cost, platform="gpu") == "pallas"
    assert resolve_backend("auto", dyn, cost, platform="cpu") == "scan"
