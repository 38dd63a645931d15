"""Softmin weighting of rollout costs.

Replaces the reference's four-phase reduction pipeline — `beta()` multi-launch
min tree, `exp_red`, `nabla()` multi-launch sum tree, `weights_kernel`
(reference src/point_mass.cu:273-382, 510-575, 628-666, 743-754) — with a
single fused expression. Under a sharded mesh, `axis_name` turns the min/sum
into `lax.pmin`/`lax.psum` across the mesh; that is the *entire* cross-device
communication of an MPPI solve (two scalar all-reduces).

    β   = min_k S_k
    e_k = exp(−(S_k − β) / λ)
    η   = Σ_k e_k
    w_k = e_k / η
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SoftminResult(NamedTuple):
    weights: jax.Array  # (K_local,)
    beta: jax.Array     # scalar (global under axis_name)
    eta: jax.Array      # scalar (global under axis_name)


def softmin_weights(
    costs: jax.Array,
    lambda_: jax.Array,
    *,
    axis_name: str | None = None,
) -> SoftminResult:
    beta = jnp.min(costs)
    if axis_name is not None:
        beta = jax.lax.pmin(beta, axis_name)
    e = jnp.exp(-(costs - beta) / lambda_)
    eta = jnp.sum(e)
    if axis_name is not None:
        eta = jax.lax.psum(eta, axis_name)
    return SoftminResult(weights=e / eta, beta=beta, eta=eta)
