"""Counter-based Gaussian noise shared by the fused rollout kernels, the plain
reference and the debug dump.

The reference gives each CUDA thread its own stateful cuRAND generator
(reference src/point_mass.cu:493-506). Here every noise value is a pure
function of ``(solve key, rollout, t, action-dim pair)``: threefry2x32
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11) on the
counter ``(rollout, t·⌈A/2⌉ + pair)``, keyed by the solve key's two words,
then Box-Muller on the two output words. The functions below are plain
``jnp`` uint32/f32 arithmetic, so the same code runs inside a Pallas kernel
(one rollout per lane of a ``(BLOCK,)`` vector) and outside it on a whole
``(T, K)`` grid: the kernels, :func:`noise_tensor` (the oracle's and the
debug dump's ε) and any replay see the same stream.

Stream conventions, shared by every consumer:

* ``antithetic``: rollout ``k < K/2`` draws counter ``k``; rollout
  ``k ≥ K/2`` is its mirror, ``−ε`` of counter ``k − K/2``.
* ``ou_beta = β > 0``: the unit-variance recursion ``e_0 = ν_0``,
  ``e_t = β e_{t−1} + √(1−β²) ν_t`` runs along t per rollout, then
  ``ε = σ·e``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: jax.Array, r: int) -> jax.Array:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[jax.Array, jax.Array]:
    """Threefry-2x32 with 20 rounds, bit-equal to ``jax.random``'s own
    (``jax.extend.random.threefry_2x32``). All arguments are uint32 and
    broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def key_words(key: jax.Array) -> jax.Array:
    """(2,) uint32 generator key from a ``jax.random`` key (its first two
    data words; a threefry key has exactly two)."""
    return jax.random.key_data(key).astype(jnp.uint32).reshape(-1)[:2]


def _unit_uniform(bits: jax.Array) -> jax.Array:
    """23 mantissa bits → f32 uniform in [0, 1), exact and branch-free."""
    one = jax.lax.bitcast_convert_type(
        (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32
    )
    return one - 1.0


def normals(k0, k1, rollout, t, action_dim: int) -> list[jax.Array]:
    """Standard normals ``ν[rollout, t, d]`` for ``d < action_dim``, one
    array per action dim, shaped like ``rollout`` (and ``t``) broadcast.
    ``rollout`` and ``t`` are integer arrays or scalars."""
    npair = (action_dim + 1) // 2
    r = jnp.asarray(rollout).astype(jnp.uint32)
    base = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(npair)
    out = []
    for j in range(npair):
        b0, b1 = threefry2x32(k0, k1, r, base + jnp.uint32(j))
        rad = jnp.sqrt(-2.0 * jnp.log1p(-_unit_uniform(b0)))
        th = (2.0 * math.pi) * _unit_uniform(b1)
        out.append(rad * jnp.cos(th))
        if 2 * j + 1 < action_dim:
            out.append(rad * jnp.sin(th))
    return out


def ou_coefficients(t, ou_beta: float):
    """(weight of e_{t−1}, weight of ν_t) of the OU recursion at step t."""
    c = (1.0 - ou_beta**2) ** 0.5
    first = (t == 0).astype(jnp.float32)
    return ou_beta * (1.0 - first), c + (1.0 - c) * first


def mirror(rollout, K: int, antithetic: bool):
    """(counter rollout, sign) of each rollout under the antithetic
    convention; identity and +1 without it."""
    if not antithetic:
        return rollout, jnp.float32(1.0)
    half = K // 2
    upper = (rollout >= half).astype(jnp.int32)
    return rollout - half * upper, (1 - 2 * upper).astype(jnp.float32)


def noise_tensor(
    key: jax.Array,
    T: int,
    K: int,
    action_dim: int,
    sigma: jax.Array,
    *,
    antithetic: bool = False,
    ou_beta: float = 0.0,
) -> jax.Array:
    """The (T, K, a) ε the fused kernels consume for these arguments, in
    rollout order — the plain reference's and the debug dump's noise."""
    if antithetic and K % 2:
        raise ValueError(f"antithetic sampling needs even K, got {K}")
    words = key_words(key)
    base, sign = mirror(jnp.arange(K, dtype=jnp.int32), K, antithetic)
    sign = jnp.broadcast_to(sign, (K,))
    ts = jnp.arange(T, dtype=jnp.int32)[:, None]
    nu = jnp.stack(
        normals(words[0], words[1], base[None, :], ts, action_dim), axis=-1
    )  # (T, K, a)
    if ou_beta > 0.0:

        def body(e_prev, inp):
            t, n = inp
            cp, cn = ou_coefficients(t, ou_beta)
            e = cp * e_prev + cn * n
            return e, e

        _, nu = jax.lax.scan(body, jnp.zeros_like(nu[0]), (ts[:, 0], nu))
    scale = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), (action_dim,))
    return (sign[:, None] * scale) * nu
