"""The fused kernels (ops/fused_rollout.py) in interpret mode on the CPU:
every built-in family against the plain scan reference on identical ε, the
fleet grid axis against per-robot solves, the controller paths that use
them, and the family registry."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused_check import (
    FAMILY_CONFIGS,
    check_against_reference,
    family_problem,
    kernel_solve,
    nominal,
)

FAMILIES = sorted(FAMILY_CONFIGS)
MODES = {"iid": (False, 0.0), "antithetic": (True, 0.0), "ou": (False, 0.6)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("family", FAMILIES)
def test_family_kernels_match_reference(family, mode):
    """Kernel A's S and kernel B's ΔU against rollout_costs and the einsum
    update fed noise_tensor's ε — K not a multiple of the block, so the
    padded tail is exercised too."""
    from mppi_gpu_tpu.ops import fused_rollout as fr

    dyn, cost, x0, sigma = family_problem(family)
    assert fr.family_for(dyn, cost) == family
    anti, ou = MODES[mode]
    check_against_reference(
        dyn, cost, x0, nominal(9, dyn.action_dim), sigma, K=298,
        antithetic=anti, ou_beta=ou,
    )


@pytest.mark.parametrize("K", [1, 2, 33, 256])
def test_tiny_and_exact_block_K(K):
    """K below, at and past one block (the mask must keep exactly K)."""
    dyn, cost, x0, sigma = family_problem("quadrotor")
    S, _ = check_against_reference(dyn, cost, x0, nominal(5, 2), sigma, K=K)
    assert np.isfinite(np.asarray(S[:K])).all()


def test_antithetic_pairs_are_mirrors():
    """Rollout k and k + K/2 see ε and −ε: with U = 0 the LTI costs of a
    mirrored pair differ only through the goal offset, and ΔU under equal
    weights is exactly zero."""
    from mppi_gpu_tpu.ops import fused_rollout as fr

    dyn, cost, x0, sigma = family_problem("lti")
    K, T = 64, 6
    plan = fr.plan_for(dyn, cost, K, T, 3, antithetic=True)
    words = fr.robot_words(jax.random.key(2)[None])
    rows = fr.pack_rows(dyn, cost, x0[None], sigma, plan)
    w = jnp.zeros((1, plan.Kpad)).at[0, :K].set(1.0 / K)
    dU = fr.fused_update(words, rows, w, plan, interpret=True)
    np.testing.assert_allclose(np.asarray(dU), 0.0, atol=1e-7)


def test_kernel_noise_is_the_shared_generator_bit_for_bit():
    """Kernel B with a one-hot weight returns one rollout's ε exactly: the
    in-kernel draw equals noise_tensor outside the kernel, bit for bit."""
    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.noise import noise_tensor

    dyn, cost, x0, sigma = family_problem("arm")
    K, T, key = 100, 7, jax.random.key(9)
    for anti, ou in ((False, 0.0), (True, 0.5)):
        plan = fr.plan_for(dyn, cost, K, T, 2, antithetic=anti, ou_beta=ou)
        words = fr.robot_words(key[None])
        rows = fr.pack_rows(dyn, cost, x0[None], sigma, plan)
        eps = noise_tensor(key, T, K, 2, sigma, antithetic=anti, ou_beta=ou)
        for k in (0, 37, K - 1):
            w = jnp.zeros((1, plan.Kpad)).at[0, k].set(1.0)
            got = fr.fused_update(words, rows, w, plan, interpret=True)[0]
            np.testing.assert_array_equal(np.asarray(got), np.asarray(eps[:, k]))


@pytest.mark.parametrize("family", ["lti", "quadrotor3d", "unicycle"])
@pytest.mark.parametrize("goals", [False, True])
def test_fleet_kernels_match_per_robot_solves(family, goals):
    """The robot grid axis: each robot's S and ΔU from one fleet launch equal
    its own single-robot launch (its key, state, U and — with per-robot
    goals — its cost row)."""
    from mppi_gpu_tpu.batched import _batch_goals
    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.softmin import softmin_weights

    dyn, cost, x0, sigma = family_problem(family)
    R, K, T, a = 3, 150, 6, dyn.action_dim
    xs = x0[None] + 0.05 * jnp.arange(R, dtype=jnp.float32)[:, None]
    Us = jnp.stack([nominal(T, a) * (1.0 + 0.1 * r) for r in range(R)])
    keys = jax.random.split(jax.random.key(4), R)
    axes, costs = None, [cost] * R
    if goals:
        g = jnp.broadcast_to(cost.goal, (R,) + cost.goal.shape)
        g = g + 0.1 * jnp.arange(R, dtype=jnp.float32)[:, None]
        cost, axes = _batch_goals(cost, g)
        costs = [jax.tree_util.tree_map(
            lambda leaf, ax: leaf if ax is None else leaf[r], cost, axes,
            is_leaf=lambda v: v is None) for r in range(R)]
    plan = fr.plan_for(dyn, costs[0], K, T, a, R=R)
    words = fr.robot_words(keys)
    rows = fr.pack_rows(dyn, cost, xs, sigma, plan, axes)
    S = fr.fused_costs(words, Us, rows, plan, interpret=True)
    w = jax.vmap(lambda s: softmin_weights(s, jnp.float32(0.7)).weights)(S)
    dU = fr.fused_update(words, rows, w, plan, interpret=True)
    for r in range(R):
        S1, _, dU1 = kernel_solve(dyn, costs[r], xs[r], Us[r], sigma, keys[r], K=K)
        np.testing.assert_allclose(np.asarray(S[r, :K]), np.asarray(S1[:K]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(dU[r]), np.asarray(dU1), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["lti", "pendulum", "quadrotor3d"])
def test_controller_pallas_solve_matches_deterministic(family):
    """MPPIController on the pallas backend equals the injected-noise
    deterministic solve fed the same ε (solve_debug's dump)."""
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController

    cfg = load_config(f"configs/{FAMILY_CONFIGS[family]}.yaml").replace(
        samples=200, horizon=8, opt_iters=1)
    ctrl = MPPIController(cfg, rollout_backend="pallas-interpret")
    x, U, key = family_problem(family)[2], ctrl.init_action_seq(), ctrl.init_key()
    res = ctrl.solve(x, U, key)
    dbg, eps, xs = ctrl.solve_debug(x, U, key)
    det = ctrl.solve_with_eps(x, U, eps)
    np.testing.assert_allclose(np.asarray(res.u_next), np.asarray(det.u_next),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dbg.u_next), np.asarray(res.u_next),
                               rtol=1e-6, atol=1e-7)
    assert xs.shape == (cfg.horizon + 1, cfg.samples, cfg.state_dim)


def test_family_dispatch_and_rejection():
    from mppi_gpu_tpu.models.neural import init_mlp_dynamics
    from mppi_gpu_tpu.ops import fused_rollout as fr

    for name in FAMILIES:
        dyn, cost, _, _ = family_problem(name)
        assert fr.family_for(dyn, cost) == name
    mlp = init_mlp_dynamics(jax.random.key(0), 4, 2)
    with pytest.raises(TypeError, match="rollout_backend='scan'"):
        fr.family_for(mlp, family_problem("lti")[1])


def test_registry_protects_builtins():
    from mppi_gpu_tpu.ops import fused_rollout as fr

    with pytest.raises(ValueError, match="built-in"):
        fr.unregister_family("lti")
    with pytest.raises(ValueError, match="unknown fused family"):
        fr.make_plan(10, 5, 2, family="no-such-family")


def test_taylor_carry_stays_finite_on_extreme_state():
    """A rollout already diverging (huge rates) must stay finite or go to
    +inf cost, never NaN, so the softmin drops it (sincos_small's
    out-of-range contract)."""
    dyn, cost, x0, sigma = family_problem("cartpole")
    x0 = jnp.asarray([0.0, 3.0, 0.0, 40.0])
    S, w, dU = kernel_solve(dyn, cost, x0, nominal(20, 1), sigma,
                            jax.random.key(1), K=64)
    assert not np.isnan(np.asarray(S[:64])).any()
    assert np.isfinite(np.asarray(dU)).all() or np.isnan(np.asarray(w)).all()
