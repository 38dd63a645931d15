"""Rollout cost functions.

Semantics of :class:`QuadraticCost` match the reference's `Cost`
(reference src/cost.cu:42-64):

    step(x', u, ε)  = λ · Σ_i u_i · Σ⁻¹_ii · ε_i  +  Σ_j w_j (x'_j − g_j)²
    final(x)        =                              Σ_j w_j (x_j  − g_j)²

where ``x'`` is the state *after* applying ``u + ε`` (the reference evaluates
step cost on x_{t+1}, src/point_mass_gpu.cu:107). The total rollout cost is
``Σ_{t<T} step(x_{t+1}, u_t, ε_t) + final(x_T)`` — note the reference counts
the terminal state cost twice (once in the last step cost, once in final); we
preserve that for parity.

Unlike the reference (which hardcodes Σ⁻¹ = I, src/point_mass_gpu.cu:58-61,
and λ = 1, src/point_mass.cu:53), both are wired parameters here.

Costs are pytree dataclasses: new cost types register via
``@register_cost("name")`` and become selectable from YAML ``cost.type``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import jax
import jax.numpy as jnp
from jax.tree_util import register_dataclass

from mppi_gpu_tpu.config import MPPIConfig


@runtime_checkable
class Cost(Protocol):
    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        """(..., s), (a,) or (..., a), (..., a) → (...) per-sample step cost."""

    def final(self, x: jax.Array) -> jax.Array:
        """(..., s) → (...) terminal cost."""


@register_dataclass
@dataclass(frozen=True)
class QuadraticCost:
    w: jax.Array        # (s,) state-cost diagonal
    goal: jax.Array     # (s,)
    lambda_: jax.Array  # scalar temperature
    inv_s: jax.Array    # (a,) diagonal of Σ⁻¹

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        ctrl = self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1)
        d = x_next - self.goal
        return ctrl + jnp.sum(d * self.w * d, axis=-1)

    def final(self, x: jax.Array) -> jax.Array:
        d = x - self.goal
        return jnp.sum(d * self.w * d, axis=-1)


@register_dataclass
@dataclass(frozen=True)
class ObstacleCost:
    """Quadratic goal cost + spherical-obstacle penalty (no reference analog
    — the registry extension point the reference's unused `cost.type` key
    implied). Obstacles are (center..., radius) spheres in POSITION space;
    a rollout pays `penalty` per step spent inside any obstacle. The
    indicator needs no smoothing: MPPI is gradient-free, the softmin simply
    never selects colliding rollouts once penalty ≫ typical path cost."""

    base: QuadraticCost
    centers: jax.Array   # (M, a) obstacle centers in position space
    radii: jax.Array     # (M,)
    penalty: jax.Array   # scalar

    @property
    def lambda_(self) -> jax.Array:
        """Softmin temperature (delegated to the base quadratic cost so the
        generic solve/kernel packing can treat every cost uniformly)."""
        return self.base.lambda_

    @property
    def inv_s(self) -> jax.Array:
        """Σ⁻¹ diagonal of the control term (delegated like ``lambda_``)."""
        return self.base.inv_s

    def _obstacle(self, x: jax.Array) -> jax.Array:
        a = self.centers.shape[-1]
        q = x[..., None, :a]                                  # (..., 1, a)
        d2 = jnp.sum((q - self.centers) ** 2, axis=-1)        # (..., M)
        inside = d2 < self.radii**2
        return self.penalty * jnp.sum(inside.astype(x.dtype), axis=-1)

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        return self.base.step(x_next, u, eps) + self._obstacle(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self.base.final(x) + self._obstacle(x)


@register_dataclass
@dataclass(frozen=True)
class PendulumSwingupCost:
    """Swing-up cost for the pendulum family: ``w_angle·(1 − cos θ) +
    w_vel·θ̇²`` per step (θ=0 upright — the trig form handles angle wrap,
    which a quadratic on θ cannot), plus the standard MPPI control term."""

    w_angle: jax.Array
    w_vel: jax.Array
    lambda_: jax.Array
    inv_s: jax.Array  # (a,)

    def _state(self, x: jax.Array) -> jax.Array:
        return self.w_angle * (1.0 - jnp.cos(x[..., 0])) + self.w_vel * x[..., 1] ** 2

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        ctrl = self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1)
        return ctrl + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


@register_dataclass
@dataclass(frozen=True)
class UnicycleWaypointCost:
    """Waypoint cost for the unicycle family: ``w = [w_pos, w_head]`` —
    quadratic distance to the goal position plus a wrap-safe
    face-the-goal term ``w_head·(1 − d̂·ĥ)`` where d̂ is the unit vector to
    the goal and ĥ = (cos θ, sin θ) the heading: zero iff the robot points
    straight at the waypoint, no atan2 (one rsqrt — kernel-friendly), and
    it fades out naturally as the robot arrives (the ε in the rsqrt keeps
    it finite AT the goal). ``goal[0:2]`` is the waypoint; ``goal[2]``
    exists only for the state_dim=3 config schema and is unused."""

    w: jax.Array        # (2,) = [w_pos, w_head]
    goal: jax.Array     # (3,)
    lambda_: jax.Array
    inv_s: jax.Array    # (a,)

    _EPS = 1e-3  # m²; keeps the bearing term finite at the waypoint

    def _state(self, x: jax.Array) -> jax.Array:
        dx = self.goal[0] - x[..., 0]
        dy = self.goal[1] - x[..., 1]
        d2 = dx * dx + dy * dy
        align = (dx * jnp.cos(x[..., 2]) + dy * jnp.sin(x[..., 2])) * jax.lax.rsqrt(d2 + self._EPS)
        return self.w[0] * d2 + self.w[1] * (1.0 - align)

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        ctrl = self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1)
        return ctrl + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


@register_dataclass
@dataclass(frozen=True)
class ArmReachCost:
    """Reaching cost for the two-link arm family: ``w = [w_pos, w_vel]`` —
    quadratic end-effector distance to the target point plus a joint-rate
    damping term. The end-effector position comes from the forward
    kinematics ``p = l1·(cos q1, sin q1) + l2·(cos(q1+q2), sin(q1+q2))``
    (same link lengths as the dynamics). ``goal[0:2]`` is the target
    (tx, ty); ``goal[2:4]`` exist only for the state_dim=4 config schema
    and are unused."""

    w: jax.Array        # (2,) = [w_pos, w_vel]
    goal: jax.Array     # (4,)
    lambda_: jax.Array
    inv_s: jax.Array    # (a,)
    # link lengths: plain-float defaults matching TwoLinkArmDynamics.create.
    # Deliberately NOT jnp scalars (module import must not init the XLA
    # backend) and NOT set in __post_init__ (register_dataclass re-runs
    # __init__ on every unflatten, so a post-init default would overwrite
    # the None leaves of tree-mapped axis/spec pytrees with arrays).
    l1: jax.Array = 0.5
    l2: jax.Array = 0.5

    def _state(self, x: jax.Array) -> jax.Array:
        q1, q12 = x[..., 0], x[..., 0] + x[..., 1]
        ex = self.l1 * jnp.cos(q1) + self.l2 * jnp.cos(q12)
        ey = self.l1 * jnp.sin(q1) + self.l2 * jnp.sin(q12)
        dx, dy = ex - self.goal[0], ey - self.goal[1]
        vel = x[..., 2] ** 2 + x[..., 3] ** 2
        return self.w[0] * (dx * dx + dy * dy) + self.w[1] * vel

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        ctrl = self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1)
        return ctrl + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


@register_dataclass
@dataclass(frozen=True)
class CartPoleBalanceCost:
    """Balance cost for the cart-pole family: keep the pole upright, the cart
    centered, and both velocities low. ``w = [w_pos, w_angle, w_posvel,
    w_angvel]``; the angle term is wrap-safe (1 − cos θ)."""

    w: jax.Array        # (4,)
    lambda_: jax.Array
    inv_s: jax.Array    # (a,)

    def _state(self, x: jax.Array) -> jax.Array:
        return (
            self.w[0] * x[..., 0] ** 2
            + self.w[1] * (1.0 - jnp.cos(x[..., 1]))
            + self.w[2] * x[..., 2] ** 2
            + self.w[3] * x[..., 3] ** 2
        )

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        return self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1) + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


@register_dataclass
@dataclass(frozen=True)
class QuadrotorHoverCost:
    """Hover/waypoint cost for the planar-quadrotor family: quadratic on
    position and velocities toward ``goal``, wrap-safe ``(1 − cos θ)`` on
    the tilt (goal tilt/rates are the level-hover zeros). ``w = [w_px,
    w_pz, w_th, w_vx, w_vz, w_om]``; plus the standard MPPI control term."""

    w: jax.Array        # (6,)
    goal: jax.Array     # (6,) — only [0:2] (position) is nonzero in practice
    lambda_: jax.Array
    inv_s: jax.Array    # (a,)

    def _state(self, x: jax.Array) -> jax.Array:
        dx, dz = x[..., 0] - self.goal[0], x[..., 1] - self.goal[1]
        return (
            self.w[0] * dx * dx
            + self.w[1] * dz * dz
            + self.w[2] * (1.0 - jnp.cos(x[..., 2]))
            + self.w[3] * x[..., 3] ** 2
            + self.w[4] * x[..., 4] ** 2
            + self.w[5] * x[..., 5] ** 2
        )

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        return self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1) + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


@register_dataclass
@dataclass(frozen=True)
class Quadrotor3DHoverCost:
    """Hover/waypoint cost for the 3-D quadrotor family. ``w = [w_px, w_py,
    w_pz, w_tilt, w_vx, w_vy, w_vz, w_om]``: per-axis quadratic position
    error toward ``goal[0:3]``, tilt as ``2(qx² + qy²)`` = 1 − (R(q)ẑ)·ẑ
    (wrap-safe, polynomial in the unit quaternion — zero iff the body z
    axis points straight up, yaw-invariant), per-axis velocity toward
    ``goal[7:10]``, and |ω|²; plus the standard MPPI control term."""

    w: jax.Array        # (8,)
    goal: jax.Array     # (13,) — [0:3] position, [7:10] velocity; rest unused
    lambda_: jax.Array
    inv_s: jax.Array    # (4,)

    def _state(self, x: jax.Array) -> jax.Array:
        dp = x[..., 0:3] - self.goal[0:3]
        dv = x[..., 7:10] - self.goal[7:10]
        tilt = 2.0 * (x[..., 4] ** 2 + x[..., 5] ** 2)
        return (
            jnp.sum(dp * self.w[0:3] * dp, axis=-1)
            + self.w[3] * tilt
            + jnp.sum(dv * self.w[4:7] * dv, axis=-1)
            + self.w[7] * jnp.sum(x[..., 10:13] ** 2, axis=-1)
        )

    def step(self, x_next: jax.Array, u: jax.Array, eps: jax.Array) -> jax.Array:
        return self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1) + self._state(x_next)

    def final(self, x: jax.Array) -> jax.Array:
        return self._state(x)


CostFactory = Callable[[MPPIConfig], Cost]
COST_REGISTRY: dict[str, CostFactory] = {}


def register_cost(name: str) -> Callable[[CostFactory], CostFactory]:
    def deco(fn: CostFactory) -> CostFactory:
        COST_REGISTRY[name] = fn
        return fn

    return deco


@register_cost("quadratic")
def _make_quadratic(cfg: MPPIConfig) -> QuadraticCost:
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:  # reference parity: Σ⁻¹ = I
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return QuadraticCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        goal=jnp.asarray(cfg.goal, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("obstacle")
def _make_obstacle(cfg: MPPIConfig) -> ObstacleCost:
    if not cfg.obstacles:
        raise ValueError(
            "cost.type 'obstacle' needs cost.obstacles: a list of "
            "[center..., radius] entries (center dims = action-dim)"
        )
    for o in cfg.obstacles:
        if len(o) != cfg.action_dim + 1:
            raise ValueError(
                f"each obstacle needs {cfg.action_dim} center coords + radius, "
                f"got {len(o)} values: {o}"
            )
    obs = jnp.asarray(cfg.obstacles, jnp.float32)
    return ObstacleCost(
        base=_make_quadratic(cfg),
        centers=obs[:, :-1],
        radii=obs[:, -1],
        penalty=jnp.float32(cfg.obstacle_w),
    )


@register_cost("pendulum")
def _make_pendulum(cfg: MPPIConfig) -> PendulumSwingupCost:
    if len(cfg.cost_w) != 2:
        raise ValueError(
            f"pendulum cost needs cost.w = [w_angle, w_vel], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return PendulumSwingupCost(
        w_angle=jnp.float32(cfg.cost_w[0]),
        w_vel=jnp.float32(cfg.cost_w[1]),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("unicycle")
def _make_unicycle(cfg: MPPIConfig) -> UnicycleWaypointCost:
    if len(cfg.cost_w) != 2:
        raise ValueError(
            f"unicycle cost needs cost.w = [w_pos, w_head], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return UnicycleWaypointCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        goal=jnp.asarray(cfg.goal, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("arm")
def _make_arm(cfg: MPPIConfig) -> "ArmReachCost":
    if len(cfg.cost_w) != 2:
        raise ValueError(
            f"arm cost needs cost.w = [w_pos, w_vel], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return ArmReachCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        goal=jnp.asarray(cfg.goal, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("cartpole")
def _make_cartpole(cfg: MPPIConfig) -> CartPoleBalanceCost:
    if len(cfg.cost_w) != 4:
        raise ValueError(
            f"cartpole cost needs cost.w = [w_pos, w_angle, w_posvel, w_angvel], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return CartPoleBalanceCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("quadrotor")
def _make_quadrotor(cfg: MPPIConfig) -> QuadrotorHoverCost:
    if len(cfg.cost_w) != 6:
        raise ValueError(
            "quadrotor cost needs cost.w = [w_px, w_pz, w_th, w_vx, w_vz, "
            f"w_om], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return QuadrotorHoverCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        goal=jnp.asarray(cfg.goal, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


@register_cost("quadrotor3d")
def _make_quadrotor3d(cfg: MPPIConfig) -> Quadrotor3DHoverCost:
    if len(cfg.cost_w) != 8:
        raise ValueError(
            "quadrotor3d cost needs cost.w = [w_px, w_py, w_pz, w_tilt, "
            f"w_vx, w_vy, w_vz, w_om], got {cfg.cost_w}"
        )
    if cfg.inv_sigma == "from-noise":
        inv_s = 1.0 / (jnp.asarray(cfg.noise, jnp.float32) ** 2)
    else:
        inv_s = jnp.ones((cfg.action_dim,), jnp.float32)
    return Quadrotor3DHoverCost(
        w=jnp.asarray(cfg.cost_w, jnp.float32),
        goal=jnp.asarray(cfg.goal, jnp.float32),
        lambda_=jnp.float32(cfg.lambda_),
        inv_s=inv_s,
    )


def make_cost(cfg: MPPIConfig) -> Cost:
    try:
        factory = COST_REGISTRY[cfg.cost_type]
    except KeyError:
        raise ValueError(
            f"unknown cost.type '{cfg.cost_type}'; known: {sorted(COST_REGISTRY)}"
        ) from None
    return factory(cfg)
