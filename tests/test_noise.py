"""The counter-based generator shared by the fused kernels, the plain
reference and the debug dump (ops/noise.py)."""

from __future__ import annotations

import jax
import jax.extend.random as jr
import jax.numpy as jnp
import numpy as np
import pytest

from mppi_gpu_tpu.ops import noise


@pytest.mark.parametrize("key", [(0, 0), (123, 456), (0xFFFFFFFF, 7), (42, 0x1BD11BDA)])
@pytest.mark.parametrize("n", [1, 17, 256])
def test_threefry_is_jax_threefry_bit_for_bit(key, n):
    k = jnp.asarray(key, jnp.uint32)
    x0 = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    x1 = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(5)
    y0, y1 = noise.threefry2x32(k[0], k[1], x0, x1)
    ref = jr.threefry_2x32(k, jnp.concatenate([x0, x1]))
    np.testing.assert_array_equal(np.concatenate([y0, y1]), np.asarray(ref))


@pytest.mark.parametrize("a", [1, 2, 3, 4])
def test_deterministic_per_key(a):
    key = jax.random.key(3)
    e1 = noise.noise_tensor(key, 5, 40, a, jnp.ones(a))
    e2 = noise.noise_tensor(key, 5, 40, a, jnp.ones(a))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
    assert e1.shape == (5, 40, a)


def test_distinct_keys_and_counters_give_distinct_noise():
    e1 = noise.noise_tensor(jax.random.key(1), 4, 64, 3, jnp.ones(3))
    e2 = noise.noise_tensor(jax.random.fold_in(jax.random.key(1), 1), 4, 64, 3, jnp.ones(3))
    assert float(jnp.mean(jnp.abs(e1 - e2))) > 0.5
    flat = np.asarray(e1).reshape(-1)
    assert len(np.unique(flat)) == flat.size  # no repeated (rollout, t, dim)


def test_prefix_stable_in_K_and_T():
    """ε of rollout k at step t does not depend on K or T (a counter, not a
    stream): a longer horizon or more rollouts extend the tensor."""
    key, s = jax.random.key(8), jnp.asarray([0.5, 2.0])
    small = noise.noise_tensor(key, 6, 50, 2, s)
    big = noise.noise_tensor(key, 9, 120, 2, s)
    np.testing.assert_array_equal(np.asarray(big[:6, :50]), np.asarray(small))


@pytest.mark.parametrize("a", [1, 3])
def test_moments_are_standard_normal(a):
    e = np.asarray(noise.noise_tensor(jax.random.key(0), 50, 20_000, a, jnp.ones(a)))
    assert abs(e.mean()) < 5e-3
    assert abs(e.std() - 1.0) < 5e-3
    assert abs(np.mean(e**4) - 3.0) < 0.05  # Gaussian kurtosis
    assert np.abs(e).max() < np.sqrt(46 * np.log(2)) + 1e-5  # 23-bit uniform cap
    if a > 1:  # the cos and sin branches of one Box-Muller pair are uncorrelated
        assert abs(np.corrcoef(e[..., 0].ravel(), e[..., 1].ravel())[0, 1]) < 5e-3


def test_sigma_scales_per_dim():
    key = jax.random.key(5)
    unit = noise.noise_tensor(key, 3, 30, 2, jnp.ones(2))
    scaled = noise.noise_tensor(key, 3, 30, 2, jnp.asarray([0.5, 3.0]))
    np.testing.assert_allclose(np.asarray(scaled), np.asarray(unit) * [0.5, 3.0], rtol=1e-6)


def test_antithetic_second_half_mirrors_first():
    e = np.asarray(noise.noise_tensor(jax.random.key(2), 4, 60, 3, jnp.ones(3), antithetic=True))
    np.testing.assert_array_equal(e[:, 30:], -e[:, :30])
    iid = np.asarray(noise.noise_tensor(jax.random.key(2), 4, 30, 3, jnp.ones(3)))
    np.testing.assert_array_equal(e[:, :30], iid)
    with pytest.raises(ValueError, match="even K"):
        noise.noise_tensor(jax.random.key(2), 4, 61, 3, jnp.ones(3), antithetic=True)


@pytest.mark.parametrize("beta", [0.3, 0.8])
def test_ou_recursion_and_stationary_variance(beta):
    key = jax.random.key(6)
    nu = np.asarray(noise.noise_tensor(key, 40, 20_000, 1, jnp.ones(1)))
    e = np.asarray(noise.noise_tensor(key, 40, 20_000, 1, jnp.ones(1), ou_beta=beta))
    np.testing.assert_array_equal(e[0], nu[0])
    c = np.sqrt(1 - beta**2)
    np.testing.assert_allclose(e[5], beta * e[4] + c * nu[5], rtol=1e-5, atol=1e-6)
    assert abs(e[-1].std() - 1.0) < 0.02
    lag1 = np.corrcoef(e[20].ravel(), e[21].ravel())[0, 1]
    assert abs(lag1 - beta) < 0.02


def test_key_words_take_the_threefry_key_data():
    key = jax.random.key(77)
    np.testing.assert_array_equal(
        np.asarray(noise.key_words(key)), np.asarray(jax.random.key_data(key))
    )
