"""Full 3-D quadrotor (quaternion SE(3) rigid body) — the fifth model
family, and the first with A=4 coupled action dims and a quaternion state.
The reference's models are all per-axis decoupled LTI (reference
src/point_mass_gpu.cu:97-106); pluggable model families are its roadmap
(reference README TODO + src/controller_base.cpp).

State ``x = [p(3), q(4), v(3), ω(3)]`` (13 dims): world position, unit
quaternion body→world (w, x, y, z — MuJoCo's freejoint convention, so the
state vector equals [qpos, qvel] of the MuJoCo plant verbatim), world
linear velocity, BODY-frame angular velocity.

Action ``u = [F, τx, τy, τz]`` — MIXER space, like the planar family
(models/quadrotor.py): collective thrust along body +z plus body torques,
the wrench a flight stack's rate controller commands. The ground-truth
worlds invert the "+"-configuration mixer to per-rotor thrusts

    f1 = F/4 − τy/(2r) + τz/(4κ)      (front, +x arm, CCW)
    f2 = F/4 + τx/(2r) − τz/(4κ)      (left,  +y arm, CW)
    f3 = F/4 + τy/(2r) + τz/(4κ)      (back,  −x arm, CCW)
    f4 = F/4 − τx/(2r) − τz/(4κ)      (right, −y arm, CW)

clamp each to [0, f_max] and reconstitute the achieved wrench; the model
stays unclamped (the deliberate model-plant gap). Same rationale as the
planar family: iid MPPI noise in rotor space random-walks the attitude
into garbage; in mixer space σ_τ can be an order of magnitude below σ_F.

Dynamics (diagonal body inertia J = diag(Jx, Jy, Jz)):

    ṗ = v
    v̇ = R(q)·ẑ · F/m − g·ẑ          R(q)ẑ = (2(qx qz + qw qy),
                                              2(qy qz − qw qx),
                                              1 − 2(qx² + qy²))
    q̇ = ½ q ⊗ (0, ω)
    ω̇ = J⁻¹ (τ − ω × Jω)

Integrated with one RK2 (midpoint) step of ``dt`` per horizon step like
the other nonlinear families, with ONE quaternion renormalization at the
end of the step (the midpoint stays unnormalized — at control-rate dt the
drift is O(dt²) and the fused kernel mirrors this exactly). Notably the
whole step is polynomial + a single rsqrt: no transcendentals at all,
which makes this 13-state family CHEAPER per state dim than the trig
families."""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
from jax.tree_util import register_dataclass


@register_dataclass
@dataclass(frozen=True)
class Quadrotor3DDynamics:
    dt: jax.Array        # integration step per horizon step
    mass: jax.Array      # m (kg)
    inertia: jax.Array   # (3,) diagonal of J (kg·m²)
    gravity: jax.Array   # g (m/s²)
    state_dim: int = field(metadata=dict(static=True), default=13)
    action_dim: int = field(metadata=dict(static=True), default=4)

    @staticmethod
    def create(
        dt: float,
        mass: float = 0.8,
        inertia: tuple[float, float, float] = (0.005, 0.005, 0.009),
        gravity: float = 9.81,
    ) -> "Quadrotor3DDynamics":
        return Quadrotor3DDynamics(
            dt=jnp.float32(dt), mass=jnp.float32(mass),
            inertia=jnp.asarray(inertia, jnp.float32),
            gravity=jnp.float32(gravity),
        )

    def derivs(self, q: jax.Array, v: jax.Array, om: jax.Array, u: jax.Array):
        """(q̇, v̇, ω̇) — position rate is just v. `q` (..., 4) need not be
        normalized (midpoint states aren't); thrust direction then scales
        with |q|², matching the fused kernel bit-for-bit."""
        qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        wx, wy, wz = om[..., 0], om[..., 1], om[..., 2]
        F = u[..., 0]
        fm = F / self.mass
        acc = jnp.stack(
            [
                2.0 * (qx * qz + qw * qy) * fm,
                2.0 * (qy * qz - qw * qx) * fm,
                (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - self.gravity,
            ],
            axis=-1,
        )
        qdot = 0.5 * jnp.stack(
            [
                -(qx * wx + qy * wy + qz * wz),
                qw * wx + qy * wz - qz * wy,
                qw * wy + qz * wx - qx * wz,
                qw * wz + qx * wy - qy * wx,
            ],
            axis=-1,
        )
        jx, jy, jz = self.inertia[0], self.inertia[1], self.inertia[2]
        omdot = jnp.stack(
            [
                (u[..., 1] - (jz - jy) * wy * wz) / jx,
                (u[..., 2] - (jx - jz) * wz * wx) / jy,
                (u[..., 3] - (jy - jx) * wx * wy) / jz,
            ],
            axis=-1,
        )
        return qdot, acc, omdot

    def step(self, x: jax.Array, u: jax.Array) -> jax.Array:
        p, q = x[..., 0:3], x[..., 3:7]
        v, om = x[..., 7:10], x[..., 10:13]
        h = self.dt
        # RK2 midpoint (command held over the step, like the other families)
        qd1, a1, wd1 = self.derivs(q, v, om, u)
        q_m = q + 0.5 * h * qd1
        v_m = v + 0.5 * h * a1
        om_m = om + 0.5 * h * wd1
        qd2, a2, wd2 = self.derivs(q_m, v_m, om_m, u)
        q_n = q + h * qd2
        q_n = q_n * jax.lax.rsqrt(jnp.sum(q_n * q_n, axis=-1, keepdims=True))
        return jnp.concatenate(
            [p + h * v_m, q_n, v + h * a2, om + h * wd2], axis=-1
        )
