"""Batched stochastic rollouts (JAX reference path).

The reference runs one CUDA thread per rollout with a sequential T-loop
(reference src/point_mass.cu:493-508, src/point_mass_gpu.cu:111-121). Here the
whole batch advances together: one `lax.scan` over T whose body is a batched
dynamics step + cost over all K rollouts — XLA fuses each step into a handful
of elementwise kernels, and the sequential horizon stays on the device.
Trajectories are *not*
materialized on the cost path (the reference keeps the full (K, T+1, s) state
history resident for debugging; here that is the opt-in
:func:`rollout_trajectories`).

Two layouts:

* **flat** (:func:`rollout_costs`) — state ``(K, s)``, noise ``(T, K, a)``.
  The readable oracle form; also the injected-noise/deterministic path.
* **tiled SoA** (:func:`rollout_costs_tiled`) — state ``(s, R, 128)``, noise
  ``(T, a, R, 128)`` with ``R`` a multiple of 8: rollouts on the two minor
  axes, the tiny ``s``/``a`` dims (1-13) on the major one, from plain
  `vmap`-ed user dynamics. This is the default scan layout; which layout is
  faster on the GPU is not measured yet.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from mppi_gpu_tpu.models.base import Dynamics
from mppi_gpu_tpu.ops.cost import Cost

# Unroll factor for the horizon scan. The scan body is a handful of small
# fused ops over (K, ·) tensors, so at large K the loop's fixed
# per-iteration cost is a visible fraction of the solve; unrolling
# amortizes it (identical numerics — unroll only changes code layout).
# Tunable for measurement via MPPI_SCAN_UNROLL.
_UNROLL = max(1, int(os.environ.get("MPPI_SCAN_UNROLL", "1")))

# The tiled layout shapes the rollout batch as (R, LANE) with R a multiple
# of SUB.
LANE = 128
SUB = 8


def round_up_k(n: int) -> int:
    """Rollout count padded up to a whole number of (8, 128) tiles."""
    return -(-n // (SUB * LANE)) * (SUB * LANE)


def rollout_costs(
    dyn: Dynamics,
    cost: Cost,
    x0: jax.Array,     # (s,) or (K, s) initial state (shared across rollouts)
    U: jax.Array,      # (T, a) nominal action sequence
    eps: jax.Array,    # (T, K, a) sampled action noise
) -> jax.Array:
    """Total cost per rollout: (K,)."""
    K = eps.shape[1]
    x0 = jnp.broadcast_to(x0, (K, x0.shape[-1])).astype(jnp.float32)

    def body(x, inp):
        u_t, e_t = inp                        # (a,), (K, a)
        x_next = dyn.step(x, u_t + e_t)       # (K, s)
        c = cost.step(x_next, u_t, e_t)       # (K,)
        return x_next, c

    xT, cs = jax.lax.scan(body, x0, (U, eps), unroll=_UNROLL)
    return jnp.sum(cs, axis=0) + cost.final(xT)


def rollout_costs_tiled(
    dyn: Dynamics,
    cost: Cost,
    x0: jax.Array,     # (s,) initial state (shared across rollouts)
    U: jax.Array,      # (T, a) nominal action sequence
    eps: jax.Array,    # (T, a, R, LANE) sampled action noise, tiled layout
) -> jax.Array:
    """Total cost per rollout in the tiled SoA layout: (R, LANE).

    The user-facing ``Dynamics.step`` / ``Cost.step`` contracts are
    unchanged — both are mapped per-sample with ``vmap(..., in_axes=-1)``
    twice, so inside the model code ``x`` is a plain ``(s,)`` vector exactly
    as in the single-sample case. The protocol already requires ``step`` to
    be pure/traceable and broadcast over (possibly zero) leading batch dims
    (models/base.py), which is precisely vmap-compatibility. Flat and tiled
    rollouts agree to float tolerance on identical noise (test_core_math).
    """
    R = eps.shape[2]
    step_v = jax.vmap(
        jax.vmap(dyn.step, in_axes=(-1, -1), out_axes=-1),
        in_axes=(-1, -1), out_axes=-1,
    )
    cost_v = jax.vmap(
        jax.vmap(cost.step, in_axes=(-1, None, -1), out_axes=-1),
        in_axes=(-1, None, -1), out_axes=-1,
    )
    final_v = jax.vmap(
        jax.vmap(cost.final, in_axes=-1, out_axes=-1), in_axes=-1, out_axes=-1
    )
    s = x0.shape[-1]
    x0T = jnp.broadcast_to(
        x0.astype(jnp.float32)[:, None, None], (s, R, LANE)
    )

    def body(x, inp):
        u_t, e_t = inp                            # (a,), (a, R, LANE)
        x_next = step_v(x, u_t[:, None, None] + e_t)
        c = cost_v(x_next, u_t, e_t)              # (R, LANE)
        return x_next, c

    xT, cs = jax.lax.scan(body, x0T, (U, eps), unroll=_UNROLL)
    return jnp.sum(cs, axis=0) + final_v(xT)


def rollout_trajectories(
    dyn: Dynamics,
    cost: Cost,
    x0: jax.Array,
    U: jax.Array,
    eps: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Debug path: full state history. Returns (costs (K,), xs (T+1, K, s))."""
    K = eps.shape[1]
    x0 = jnp.broadcast_to(x0, (K, x0.shape[-1])).astype(jnp.float32)

    def body(x, inp):
        u_t, e_t = inp
        x_next = dyn.step(x, u_t + e_t)
        c = cost.step(x_next, u_t, e_t)
        return x_next, (c, x_next)

    xT, (cs, xs) = jax.lax.scan(body, x0, (U, eps))
    xs = jnp.concatenate([x0[None], xs], axis=0)
    return jnp.sum(cs, axis=0) + cost.final(xT), xs
