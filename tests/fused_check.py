"""Shared checks for the fused kernels (ops/fused_rollout.py) in interpret
mode: kernel A's costs and kernel B's ΔU against the plain scan reference
fed the same ε from the shared generator (ops/noise.py)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")

# CPU interpret mode: both sides are XLA-CPU f32. The kernel advances angles
# by small-angle Taylor additions where the reference calls sin/cos, and the
# chaotic families (cart-pole, pendulum) amplify that rounding along T.
S_RTOL = 2e-4
# ΔU: per-block sums then a sum over blocks, against one contraction.
DU_RTOL, DU_ATOL = 1e-4, 1e-6

FAMILY_CONFIGS = {
    "lti": "point_mass3d", "pendulum": "pendulum", "cartpole": "cartpole",
    "quadrotor": "quadrotor", "quadrotor3d": "quadrotor3d",
    "unicycle": "unicycle", "arm": "arm", "lti-obstacle": "point_mass2d",
}


def family_problem(name: str):
    """(dyn, cost, x0, sigma) of a built-in family, from its shipped config
    (lti-obstacle: point_mass2d plus two obstacles on the way)."""
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.envs import make_jax_world
    from mppi_gpu_tpu.ops.cost import ObstacleCost

    cfg = load_config(os.path.join(CONFIGS, FAMILY_CONFIGS[name] + ".yaml"))
    c = MPPIController(cfg, rollout_backend="scan")
    cost = c.cost
    if name == "lti-obstacle":
        cost = ObstacleCost(
            base=cost, centers=jnp.asarray([[0.05, 0.0], [0.4, 0.1]]),
            radii=jnp.asarray([0.1, 0.2]), penalty=jnp.float32(20.0),
        )
    return c.dynamics, cost, make_jax_world(cfg).reset().x, c.sigma


def nominal(T: int, a: int) -> jax.Array:
    t = jnp.arange(T, dtype=jnp.float32)[:, None]
    return 0.3 * jnp.sin(0.4 * t + jnp.arange(a, dtype=jnp.float32))


def kernel_solve(dyn, cost, x0, U, sigma, key, *, K, antithetic=False,
                 ou_beta=0.0, lam=0.7):
    """(S (Kpad,), weights (Kpad,), ΔU (T, a)) through kernels A and B."""
    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.softmin import softmin_weights

    T, a = U.shape
    plan = fr.plan_for(dyn, cost, K, T, a, antithetic=antithetic, ou_beta=ou_beta)
    words = fr.robot_words(key[None])
    rows = fr.pack_rows(dyn, cost, jnp.asarray(x0)[None], sigma, plan)
    S = fr.fused_costs(words, U[None], rows, plan, interpret=True)[0]
    w = softmin_weights(S, jnp.float32(lam)).weights
    dU = fr.fused_update(words, rows, w[None], plan, interpret=True)[0]
    return S, w, dU


def check_against_reference(dyn, cost, x0, U, sigma, *, K, antithetic=False,
                            ou_beta=0.0, key=None, lam=0.7):
    from mppi_gpu_tpu.ops.noise import noise_tensor
    from mppi_gpu_tpu.ops.rollout import rollout_costs

    key = jax.random.key(11) if key is None else key
    T, a = U.shape
    S, w, dU = kernel_solve(dyn, cost, x0, U, sigma, key, K=K,
                            antithetic=antithetic, ou_beta=ou_beta, lam=lam)
    eps = noise_tensor(key, T, K, a, sigma, antithetic=antithetic, ou_beta=ou_beta)
    S_ref = rollout_costs(dyn, cost, x0, U, eps)
    np.testing.assert_allclose(np.asarray(S[:K]), np.asarray(S_ref), rtol=S_RTOL)
    assert np.all(np.isinf(np.asarray(S[K:]))), "padded rollouts must cost +inf"
    dU_ref = jnp.einsum("tka,k->ta", eps, w[:K], precision="highest")
    np.testing.assert_allclose(
        np.asarray(dU), np.asarray(dU_ref),
        rtol=DU_RTOL, atol=DU_ATOL + DU_RTOL * float(jnp.max(jnp.abs(dU_ref))),
    )
    return S, dU
