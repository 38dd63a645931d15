"""Iterated MPPI (cfg.opt_iters > 1): M softmin updates of the nominal
sequence per control cycle, fresh noise each iteration, one shift at the
end — standard MPPI practice the reference lacks (its loop hardcodes one
update per cycle, reference src/main.cu:326-374)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.config import ConfigError, MPPIConfig, config_from_mapping
from mppi_gpu_tpu.controller import MPPIController, mppi_solve
from mppi_gpu_tpu.ops.rollout import rollout_costs


def make_cfg(K=96, T=12, a=2, **kw):
    return MPPIConfig(
        env="t", samples=K, state_dim=2 * a, action_dim=a, horizon=T, dt=0.1,
        lambda_=1.0, noise=tuple([0.3] * a), init_act=tuple([0.0] * a),
        max_a=tuple([1.0] * a), goal=tuple([1.0] * a + [0.0] * a),
        cost_type="quadratic", cost_w=tuple([1.0] * a + [0.5] * a), **kw,
    )


def test_validation_and_yaml_key():
    with pytest.raises(ConfigError, match="opt-iters"):
        make_cfg(opt_iters=0)
    doc = {
        "env": "t", "samples": 8, "state-dim": 2, "action-dim": 1,
        "horizon": 4, "dt": 0.1, "lambda": 1.0, "noise": [0.2],
        "init-act": [0.0], "max-a": [1.0], "goal": [1.0, 0.0],
        "cost": {"type": "quadratic", "w": [1.0, 0.1]}, "opt-iters": 3,
    }
    assert config_from_mapping(doc).opt_iters == 3


@pytest.mark.parametrize("backend", ["scan", "pallas-interpret"])
def test_opt_iters_equals_manual_iteration(backend):
    """mppi_solve(opt_iters=M) must equal M manual single solves with the
    unshifted sequence fed back and keys folded by iteration index."""
    M = 3
    cfg = make_cfg(opt_iters=M)
    ctrl = MPPIController(cfg, rollout_backend=backend)
    x = jnp.asarray([0.2, -0.1, 0.0, 0.1], jnp.float32)
    U = ctrl.init_action_seq()
    key = jax.random.key(9)
    res = ctrl.solve(x, U, key)

    Uc = U
    for j in range(M):
        r = mppi_solve(
            ctrl.dynamics, ctrl.cost, x, Uc, jax.random.fold_in(key, j),
            ctrl.sigma, ctrl.lambda_, ctrl.max_a,
            K=cfg.samples, clamp=cfg.clamp_action, rollout_backend=backend,
        )
        Uc = r.info.u_seq
    np.testing.assert_allclose(
        np.asarray(res.info.u_seq), np.asarray(Uc), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(res.action), np.asarray(Uc[0]), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(res.u_next[:-1]), np.asarray(Uc[1:]), rtol=1e-5, atol=1e-7
    )
    # diagnostics are the FINAL iteration's
    np.testing.assert_allclose(
        np.asarray(res.info.costs), np.asarray(r.info.costs), rtol=1e-5
    )


def test_opt_iters_improves_nominal_cost():
    """On the convex LTI problem, iterating the update must reduce the
    noise-free rollout cost of the nominal sequence vs the starting one."""
    cfg = make_cfg(K=2048, T=30, opt_iters=4)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    x = jnp.asarray([0.0, 0.0, 0.0, 0.0], jnp.float32)
    U0 = ctrl.init_action_seq()
    res = ctrl.solve(x, U0, jax.random.key(2))

    def J(U):
        eps0 = jnp.zeros((cfg.horizon, 1, cfg.action_dim))
        return float(rollout_costs(ctrl.dynamics, ctrl.cost, x, U, eps0)[0])

    assert J(res.info.u_seq) < J(U0) * 0.8, (J(res.info.u_seq), J(U0))


def test_opt_iters_fleet_scan_matches_single():
    """The fleet (vmapped scan) honors opt_iters: robot r's result equals the
    single-robot iterated solve with the same key."""
    from mppi_gpu_tpu.batched import BatchedMPPIController

    cfg = make_cfg(opt_iters=2)
    R = 2
    fleet = BatchedMPPIController(cfg, R, rollout_backend="scan")
    xs = jnp.stack([jnp.zeros(4), jnp.full((4,), 0.2)])
    Us = fleet.init_action_seqs()
    keys = fleet.init_keys()
    res_f = fleet.solve_batch(xs, Us, keys)

    # match the fleet's vmap-exact sampler (see BatchedMPPIController)
    single = MPPIController(cfg, rollout_backend="scan", sampler="erfinv")
    for r in range(R):
        res_1 = single.solve(xs[r], Us[r], keys[r])
        np.testing.assert_allclose(
            np.asarray(res_f.action[r]), np.asarray(res_1.action),
            rtol=1e-5, atol=1e-7,
        )


def test_opt_iters_fleet_pallas_matches_manual():
    """The fleet fused kernels' iterated path (interpreted) matches
    manual iteration of the fleet core via single-iteration fleet solves."""
    from mppi_gpu_tpu.batched import BatchedMPPIController

    M, R = 2, 2
    cfg = make_cfg(K=96, T=8, a=2, opt_iters=M)
    fleet = BatchedMPPIController(
        cfg, R, rollout_backend="pallas-interpret"
    )
    xs = jnp.stack([jnp.zeros(4), jnp.full((4,), 0.1)])
    Us = fleet.init_action_seqs()
    keys = fleet.init_keys()
    res = fleet.solve_batch(xs, Us, keys)

    fleet1 = BatchedMPPIController(
        cfg.replace(opt_iters=1), R,
        rollout_backend="pallas-interpret",
    )
    fold_r = jax.vmap(jax.random.fold_in, (0, None))
    Uc = Us
    for j in range(M):
        r1 = fleet1.solve_batch(xs, Uc, fold_r(keys, j))
        Uc = r1.info.u_seq
    np.testing.assert_allclose(
        np.asarray(res.info.u_seq), np.asarray(Uc), rtol=1e-5, atol=1e-6
    )


def test_opt_iters_sharded():
    """opt_iters composes with the sharded solve (collectives inside each
    iteration) and stays deterministic."""
    from mppi_gpu_tpu.parallel import ShardedMPPIController, make_mesh

    cfg = make_cfg(K=64, T=8, a=2, opt_iters=2)
    ctrl = ShardedMPPIController(cfg, mesh=make_mesh(8))
    x = jnp.zeros(4)
    r1 = ctrl.solve(x, ctrl.init_action_seq(), ctrl.init_key())
    r2 = ctrl.solve(x, ctrl.init_action_seq(), ctrl.init_key())
    np.testing.assert_array_equal(np.asarray(r1.action), np.asarray(r2.action))
    np.testing.assert_allclose(float(r1.info.weights.sum()), 1.0, rtol=1e-5)


def test_solve_debug_documents_final_iteration():
    """solve_debug under opt_iters>1: the dumped solve must equal the hot
    path's result (it documents the final iteration)."""
    cfg = make_cfg(opt_iters=3)
    ctrl = MPPIController(cfg, rollout_backend="scan")
    x = jnp.asarray([0.1, 0.0, -0.1, 0.0], jnp.float32)
    U = ctrl.init_action_seq()
    key = jax.random.key(4)
    res_hot = ctrl.solve(x, U, key)
    res_dbg, eps, traj = ctrl.solve_debug(x, U, key)
    np.testing.assert_allclose(
        np.asarray(res_dbg.action), np.asarray(res_hot.action),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(res_dbg.info.u_seq), np.asarray(res_hot.info.u_seq),
        rtol=1e-5, atol=1e-7,
    )
    assert eps.shape == (cfg.horizon, cfg.samples, cfg.action_dim)
    assert traj.shape[0] == cfg.horizon + 1
