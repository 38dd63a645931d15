"""Multi-chip execution tests on a virtual 8-device CPU mesh.

The sharded solve must (a) run with K sharded over the mesh, (b) produce
identical results to an equivalent single-device computation when fed the
same per-shard noise, and (c) agree with the single-device solve in
distribution when sampling."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.config import MPPIConfig, load_config
from mppi_gpu_tpu.controller import (
    MPPIController,
    mppi_solve_deterministic,
    sample_noise,
)
from mppi_gpu_tpu.envs import make_jax_world
from mppi_gpu_tpu.parallel import ShardedMPPIController, make_mesh, sharded_mppi_solve

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def make_cfg(K=64, T=10, a=2):
    return MPPIConfig(
        env="t", samples=K, state_dim=2 * a, action_dim=a, horizon=T, dt=0.1,
        lambda_=1.0, noise=tuple([0.25] * a), init_act=tuple([0.0] * a),
        max_a=tuple([1.0] * a), goal=tuple([1.0] * a + [0.0] * a),
        cost_type="quadratic", cost_w=tuple([1.0] * a + [0.5] * a),
    )


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_sharded_solve_runs_and_is_deterministic(mesh8):
    cfg = make_cfg()
    ctrl = ShardedMPPIController(cfg, mesh=mesh8)
    x = jnp.zeros(4)
    U = ctrl.init_action_seq()
    r1 = ctrl.solve(x, U, ctrl.init_key())
    r2 = ctrl.solve(x, U, ctrl.init_key())
    np.testing.assert_array_equal(np.asarray(r1.action), np.asarray(r2.action))
    assert r1.info.costs.shape == (cfg.samples,)
    np.testing.assert_allclose(float(r1.info.weights.sum()), 1.0, rtol=1e-5)


def test_sharded_matches_replayed_single_device(mesh8, rng):
    """Replay the sharded run's exact noise through the single-device
    deterministic solve: results must match to reduction-order tolerance."""
    cfg = make_cfg(K=64, T=8, a=2)
    ctrl = ShardedMPPIController(cfg, mesh=mesh8)
    x = jnp.asarray(rng.normal(size=4), dtype=jnp.float32)
    U = jnp.asarray(rng.normal(size=(8, 2)) * 0.1, dtype=jnp.float32)
    key = jax.random.key(7)
    res = ctrl.solve(x, U, key)

    # reconstruct the per-device noise exactly as sharded_mppi_solve does:
    # per-shard fold_in keys, each shard's stream read back through the
    # public flat view of the tiled sampler
    n = 8
    k_loc = cfg.samples // n
    sigma = jnp.asarray(cfg.noise, jnp.float32)
    eps_parts = [
        sample_noise(
            jax.random.fold_in(key, d), cfg.horizon, k_loc, cfg.action_dim, sigma
        )
        for d in range(n)
    ]
    eps = jnp.concatenate(eps_parts, axis=1)  # (T, K, a)

    ref = mppi_solve_deterministic(
        ctrl.dynamics, ctrl.cost, x, U, eps,
        ctrl.lambda_, ctrl.max_a, clamp=cfg.clamp_action,
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
    np.testing.assert_allclose(float(res.info.beta), float(ref.info.beta), rtol=1e-6)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_any_mesh_size(n_dev):
    cfg = make_cfg(K=32, T=5, a=1)
    mesh = make_mesh(n_dev)
    ctrl = ShardedMPPIController(cfg, mesh=mesh)
    res = ctrl.solve(jnp.zeros(2), ctrl.init_action_seq(), ctrl.init_key())
    assert res.u_next.shape == (5, 1)
    np.testing.assert_allclose(float(res.info.weights.sum()), 1.0, rtol=1e-5)


def test_sharded_rejects_uneven_K(mesh8):
    cfg = make_cfg(K=13)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_mppi_solve(
            mesh8,
            None, None, jnp.zeros(4), jnp.zeros((10, 2)), jax.random.key(0),
            jnp.ones(2), jnp.float32(1.0), jnp.ones(2), K=13,
        )


SHARDED_SCENARIOS = {
    # name: (config, devices, antithetic, OU β)
    "iid-8": ("point_mass2d", 8, False, 0.0),
    "anti-4": ("point_mass2d", 4, True, 0.0),
    "ou-2": ("point_mass3d", 2, False, 0.5),
    "pendulum-8": ("pendulum", 8, False, 0.0),
    "quadrotor-4": ("quadrotor", 4, False, 0.0),
    "quadrotor3d-2": ("quadrotor3d", 2, True, 0.3),
}


@pytest.mark.parametrize("scenario", sorted(SHARDED_SCENARIOS))
def test_sharded_pallas_matches_oracle(scenario):
    """The two-kernel path under `shard_map` with real pmin/psum on the
    virtual mesh (interpreted kernels): each device draws its K/n rollouts
    from fold_in(key, device), so the single-device deterministic solve fed
    the concatenated per-shard ε from the shared generator is an exact
    replay (up to the order of the cross-device sums)."""
    from mppi_gpu_tpu.ops.noise import noise_tensor

    name, n, anti, ou = SHARDED_SCENARIOS[scenario]
    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml")).replace(
        samples=64 * n, horizon=7, antithetic=anti, noise_beta=ou, opt_iters=1)
    ctrl = ShardedMPPIController(cfg, mesh=make_mesh(n),
                                 rollout_backend="pallas-interpret")
    x = make_jax_world(cfg).reset().x
    U = ctrl.init_action_seq() + 0.1
    key = jax.random.key(31)
    res = ctrl.solve(x, U, key)

    k_loc = cfg.samples // n
    eps = jnp.concatenate([
        noise_tensor(jax.random.fold_in(key, d), cfg.horizon, k_loc,
                     cfg.action_dim, ctrl.sigma, antithetic=anti, ou_beta=ou)
        for d in range(n)
    ], axis=1)
    ref = mppi_solve_deterministic(
        ctrl.dynamics, ctrl.cost, x, U, eps,
        ctrl.lambda_, ctrl.max_a, clamp=cfg.clamp_action,
    )
    np.testing.assert_allclose(
        np.asarray(res.info.costs), np.asarray(ref.info.costs), rtol=1e-4
    )
    # the kernels' small-angle trig carry moves S by ~1e-5 relative
    # (pendulum), which the softmin passes on to the weights
    np.testing.assert_allclose(
        np.asarray(res.info.u_seq), np.asarray(ref.info.u_seq), rtol=1e-4, atol=2e-5
    )
    np.testing.assert_allclose(float(res.info.eta), float(ref.info.eta), rtol=1e-3)


def test_sharded_nonlinear_family_matches_replay(mesh8):
    """The sharded (scan) solve composes with a nonlinear model family —
    the per-shard noise reconstruction is family-independent, so the exact
    replay through the single-device deterministic solve must agree for the
    quadrotor (A=2 coupled actions, nonzero nominal) just as for the LTI."""
    cfg = MPPIConfig(
        env="quadrotor", samples=64, state_dim=6, action_dim=2, horizon=8,
        dt=1.0 / 60.0, lambda_=0.1, noise=(1.0, 0.15), init_act=(7.848, 0.0),
        max_a=(16.0, 3.0), goal=(1.0, 0.5, 0.0, 0.0, 0.0, 0.0),
        cost_type="quadrotor", cost_w=(4.0, 4.0, 10.0, 1.5, 1.5, 2.0),
    )
    ctrl = ShardedMPPIController(cfg, mesh=mesh8, rollout_backend="scan")
    x = jnp.asarray([-1.0, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    U = ctrl.init_action_seq()
    key = jax.random.key(21)
    res = ctrl.solve(x, U, key)

    n, k_loc = 8, cfg.samples // 8
    sigma = jnp.asarray(cfg.noise, jnp.float32)
    eps = jnp.concatenate(
        [
            sample_noise(
                jax.random.fold_in(key, d), cfg.horizon, k_loc,
                cfg.action_dim, sigma,
            )
            for d in range(n)
        ],
        axis=1,
    )
    ref = mppi_solve_deterministic(
        ctrl.dynamics, ctrl.cost, x, U, eps,
        ctrl.lambda_, ctrl.max_a, clamp=cfg.clamp_action,
    )
    np.testing.assert_allclose(
        np.asarray(res.action), np.asarray(ref.action), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.info.costs), np.asarray(ref.info.costs), rtol=1e-5
    )


def test_sharded_vs_single_distribution():
    """Statistical agreement: sharded and single-device solves from the same
    state should produce close actions when K is large (law of large
    numbers; different RNG streams)."""
    cfg = make_cfg(K=4096, T=10, a=1)
    x = jnp.asarray([0.5, 0.1], jnp.float32)
    single = MPPIController(cfg)
    sharded = ShardedMPPIController(cfg, mesh=make_mesh(8))
    U = single.init_action_seq()
    a1 = np.asarray(single.solve(x, U, jax.random.key(0)).action)
    a2 = np.asarray(sharded.solve(x, U, jax.random.key(1)).action)
    np.testing.assert_allclose(a1, a2, atol=0.05)
