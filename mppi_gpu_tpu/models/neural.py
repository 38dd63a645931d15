"""Neural (MLP) residual dynamics surrogate.

The reference's stated roadmap is a graph-framework controller with a learned
(NN/GP) dynamics model in the rollout (reference README TODO and the vestigial
TensorFlow sketch in src/controller_base.cpp). Here it is a first-class model:
an MLP predicting the state *residual*, ``x' = x + net([x, u])``, so an
untrained net is still a stable (identity) model.

Plain-JAX parameters (no flax dependency on the hot path) so the whole pytree
shards/jits trivially; the default hidden width is 128.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.tree_util import register_dataclass


@register_dataclass
@dataclass(frozen=True)
class MLPDynamics:
    """Residual MLP dynamics: ``x_{t+1} = x_t + scale * MLP([x_t, u_t])``."""

    weights: tuple[jax.Array, ...]   # (in, h1), (h1, h2), ..., (hn, state_dim)
    biases: tuple[jax.Array, ...]
    residual_scale: jax.Array        # scalar; 0.0 → exact identity model
    in_shift: jax.Array | None = None   # optional input standardization:
    in_scale: jax.Array | None = None   # net sees (concat([x,u]) − shift)·scale
    state_dim: int = field(metadata=dict(static=True), default=2)
    action_dim: int = field(metadata=dict(static=True), default=1)

    def step(self, x: jax.Array, u: jax.Array) -> jax.Array:
        batch = jnp.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x = jnp.broadcast_to(x, batch + (self.state_dim,))
        u = jnp.broadcast_to(u, batch + (self.action_dim,))
        h = jnp.concatenate([x, u], axis=-1)
        if (self.in_shift is None) != (self.in_scale is None):
            raise ValueError(
                "in_shift and in_scale must be set together (got exactly one)"
            )
        if self.in_shift is not None:
            # standardized inputs keep the tanh layers out of saturation when
            # raw components span decades (e.g. hover thrust ~8 vs rates ~0.1)
            h = (h - self.in_shift) * self.in_scale
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            # batched (K, in) @ (in, out): a matrix product when K is large
            h = jnp.tanh(jnp.dot(h, w, preferred_element_type=jnp.float32) + b)
        w, b = self.weights[-1], self.biases[-1]
        delta = jnp.dot(h, w, preferred_element_type=jnp.float32) + b
        return x + self.residual_scale * delta


def init_mlp_dynamics(
    key: jax.Array,
    state_dim: int,
    action_dim: int,
    hidden: Sequence[int] = (128, 128),
    residual_scale: float = 1.0,
) -> MLPDynamics:
    """Glorot-initialized residual MLP with a zero-init output layer (so the
    fresh model is the identity map — safe to drop into a running controller)."""
    dims = [state_dim + action_dim, *hidden, state_dim]
    weights, biases = [], []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        key, sub = jax.random.split(key)
        if i == len(dims) - 2:
            w = jnp.zeros((din, dout), jnp.float32)
        else:
            scale = jnp.sqrt(2.0 / (din + dout))
            w = scale * jax.random.normal(sub, (din, dout), jnp.float32)
        weights.append(w)
        biases.append(jnp.zeros((dout,), jnp.float32))
    return MLPDynamics(
        weights=tuple(weights),
        biases=tuple(biases),
        residual_scale=jnp.float32(residual_scale),
        state_dim=state_dim,
        action_dim=action_dim,
    )


@register_dataclass
@dataclass(frozen=True)
class HybridResidualDynamics:
    """Analytic model + learned residual: ``x' = base.step(x, u) +
    scale·MLP([x, u])`` — physics where we know it, a net for the gap
    (integrator coarseness, actuator clamps, unmodeled drag). The
    correction is extracted from the wrapped :class:`MLPDynamics` as
    ``mlp.step(x, u) − x``, so the same init/fit machinery applies and a
    zero-init net leaves the analytic model untouched.

    ``unit_norm_slice`` (static) optionally renormalizes a state slice
    after the correction — the quaternion of the quadrotor3d family, which
    the analytic step keeps unit but a raw residual would drift."""

    base: object          # analytic Dynamics pytree
    mlp: MLPDynamics      # residual net (its residual_scale scales the correction)
    unit_norm_slice: tuple[int, int] | None = field(
        metadata=dict(static=True), default=None
    )

    @property
    def state_dim(self) -> int:
        return self.mlp.state_dim

    @property
    def action_dim(self) -> int:
        return self.mlp.action_dim

    @property
    def dt(self):  # bench/controller introspection parity with other models
        return self.base.dt

    def step(self, x: jax.Array, u: jax.Array) -> jax.Array:
        batch = jnp.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x = jnp.broadcast_to(x, batch + (self.state_dim,))
        xn = self.base.step(x, u) + (self.mlp.step(x, u) - x)
        if self.unit_norm_slice is not None:
            lo, hi = self.unit_norm_slice
            q = xn[..., lo:hi]
            q = q * jax.lax.rsqrt(jnp.sum(q * q, axis=-1, keepdims=True))
            xn = jnp.concatenate([xn[..., :lo], q, xn[..., hi:]], axis=-1)
        return xn


def fit_residual_dynamics(
    model: HybridResidualDynamics,
    transitions: tuple[jax.Array, jax.Array, jax.Array],
    *,
    lr: float = 1e-3,
    steps: int = 500,
    whiten: bool = True,
) -> tuple[HybridResidualDynamics, jax.Array]:
    """Full-batch Adam fit of the residual net so the HYBRID prediction
    matches the observed next states; the analytic part stays frozen.
    With ``whiten`` the per-dim error is scaled by the analytic residual's
    std (floored at 5 % of the largest) — without it, one dominant gap
    component (e.g. the quadrotor's ω) soaks up all capacity while the
    net INJECTS error into components the analytic model already gets
    right. Returns (model, per-step loss history)."""
    import optax

    xs, us, xn = transitions
    if whiten:
        std = jnp.std(xn - model.base.step(xs, us), axis=0)
        err_w = 1.0 / (std + 0.05 * jnp.max(std) + 1e-12)
    else:
        err_w = jnp.ones((xn.shape[-1],), jnp.float32)

    def loss_fn(params):
        w, b = params
        m = replace(model, mlp=replace(model.mlp, weights=w, biases=b))
        pred = m.step(xs, us)
        return jnp.mean(jnp.sum(((pred - xn) * err_w) ** 2, axis=-1))

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))

    def train_step(carry, _):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    params = (model.mlp.weights, model.mlp.biases)

    @jax.jit
    def run(params):
        (params, _), losses = jax.lax.scan(
            train_step, (params, opt.init(params)), None, length=steps
        )
        return params, losses

    params, losses = run(params)
    w, b = params
    return replace(model, mlp=replace(model.mlp, weights=w, biases=b)), losses


def fit_mlp_dynamics(
    model: MLPDynamics,
    transitions: tuple[jax.Array, jax.Array, jax.Array],
    *,
    lr: float = 1e-3,
    steps: int = 500,
) -> tuple[MLPDynamics, jax.Array]:
    """Full-batch Adam (optax) fit of the surrogate on (x, u, x_next)
    transitions as one jitted `lax.scan`. Returns (model, per-step loss
    history)."""
    import optax

    xs, us, xn = transitions

    def loss_fn(params):
        w, b = params
        m = replace(model, weights=w, biases=b)
        pred = m.step(xs, us)
        return jnp.mean(jnp.sum((pred - xn) ** 2, axis=-1))

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))

    def train_step(carry, _):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    params = (model.weights, model.biases)

    @jax.jit
    def run(params):
        (params, _), losses = jax.lax.scan(
            train_step, (params, opt.init(params)), None, length=steps
        )
        return params, losses

    params, losses = run(params)
    w, b = params
    return replace(model, weights=w, biases=b), losses
