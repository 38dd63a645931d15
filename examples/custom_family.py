"""Out-of-tree fused family: kinematic bicycle (front-steer car).

This example is the worked template for the PUBLIC fused-family extension
API (``mppi_gpu_tpu.register_family``). Everything here lives in USER code —
nothing in the package is edited:

  1. ``BicycleDynamics`` / ``BicycleWaypointCost`` — ordinary scan-path
     extensions (the ``Dynamics`` protocol + the ``Cost`` protocol). These
     alone already give a working controller on ANY backend='scan' device.
  2. ``BicycleFamily`` — the fused-kernel twin of the pair, registered with
     ``@register_family``: ~40 lines over per-rollout vectors that teach the
     fused GPU kernels (ops/fused_rollout.py: the rollout kernel, the
     weighted-update kernel, fleets and meshes — all shared machinery) to
     integrate this model. After registration, backend='auto' resolves the
     pair to the fused kernels on a GPU exactly like the eight built-in
     families.

The model: rear-axle kinematic bicycle with velocity drag,

    ṗx = v·cos θ      θ̇ = v·tan δ / L
    ṗy = v·sin θ      v̇ = a − c·v

state ``x = [px, py, θ, v]``, action ``u = [a, δ]`` (acceleration, steer
angle), RK2-midpoint integration — the kernel's ``step`` mirrors
``BicycleDynamics.step`` expression-for-expression, which is what makes the
kernels agree with the scan reference (tests/test_custom_family.py).

Run:  python examples/custom_family.py [--steps 120] [--samples 1024]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
from jax.tree_util import register_dataclass

from mppi_gpu_tpu import MPPIConfig, MPPIController, register_family

# ---------------------------------------------------------------------------
# 1) scan-path extension: an ordinary Dynamics + Cost pair (pure JAX).
# ---------------------------------------------------------------------------


@register_dataclass
@dataclass(frozen=True)
class BicycleDynamics:
    dt: jax.Array
    wheelbase: jax.Array     # L
    drag: jax.Array          # c
    state_dim: int = field(metadata=dict(static=True), default=4)
    action_dim: int = field(metadata=dict(static=True), default=2)

    @staticmethod
    def create(dt: float, wheelbase: float = 0.5, drag: float = 0.3):
        return BicycleDynamics(
            dt=jnp.float32(dt), wheelbase=jnp.float32(wheelbase),
            drag=jnp.float32(drag),
        )

    def _deriv(self, x, u):
        th, v = x[..., 2], x[..., 3]
        acc, steer = u[..., 0], u[..., 1]
        # tan via sin/cos so the kernel twin uses the identical expression
        # (keeping both sides token-identical keeps the fused kernel
        # faithful to this model to f32 rounding)
        tan_d = jnp.sin(steer) / jnp.cos(steer)
        return jnp.stack(
            [
                v * jnp.cos(th),
                v * jnp.sin(th),
                v * tan_d / self.wheelbase,
                acc - self.drag * v,
            ],
            axis=-1,
        )

    def step(self, x: jax.Array, u: jax.Array) -> jax.Array:
        # RK2 midpoint — the same integrator every built-in family uses
        h = self.dt
        x_m = x + 0.5 * h * self._deriv(x, u)
        return x + h * self._deriv(x_m, u)


@register_dataclass
@dataclass(frozen=True)
class BicycleWaypointCost:
    """w = [w_pos, w_vel]: quadratic distance to the (gx, gy) waypoint plus a
    cruise-speed term (v − v_ref)² — wrap-free, one multiply per state dim."""

    w: jax.Array        # (2,)
    goal: jax.Array     # (2,) waypoint position
    v_ref: jax.Array    # scalar cruise speed
    lambda_: jax.Array
    inv_s: jax.Array    # (2,)

    def _state(self, x: jax.Array) -> jax.Array:
        dx = x[..., 0] - self.goal[0]
        dy = x[..., 1] - self.goal[1]
        dv = x[..., 3] - self.v_ref
        return self.w[0] * (dx * dx + dy * dy) + self.w[1] * dv * dv

    def step(self, x_next, u, eps):
        ctrl = self.lambda_ * jnp.sum(u * self.inv_s * eps, axis=-1)
        return ctrl + self._state(x_next)

    def final(self, x):
        return self._state(x)


# ---------------------------------------------------------------------------
# 2) fused-kernel extension: the family, registered from user code.
# ---------------------------------------------------------------------------


@register_family
class BicycleFamily:
    """Fused-kernel family for (BicycleDynamics, BicycleWaypointCost).

    The kernels run one rollout per lane of a ``(plan.block,)`` vector: the
    state is a tuple of such vectors, the two effective actions arrive as a
    list of them, and ``p(i)`` reads parameter ``i`` of this robot's row.
    """

    name = "bicycle-demo"  # parameters: w_pos, w_vel, gx, gy, v_ref, 1/L, drag, x0 (4)

    @staticmethod
    def supports(dyn, cost) -> bool:
        return isinstance(dyn, BicycleDynamics) and type(cost) is BicycleWaypointCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (4,)).astype(jnp.float32)
        return jnp.concatenate([
            cost.w.astype(jnp.float32), cost.goal.astype(jnp.float32),
            jnp.stack([cost.v_ref, 1.0 / dyn.wheelbase, dyn.drag]).astype(jnp.float32),
            x0,
        ])

    @staticmethod
    def build_planar(p, dt, plan):
        w_pos, w_vel, gx, gy, v_ref, inv_l, drag = (p(i) for i in range(7))

        def deriv(s, acc, tan_d):
            px, py, th, v = s
            return (
                v * jnp.cos(th),
                v * jnp.sin(th),
                v * tan_d * inv_l,
                acc - drag * v,
            )

        def state_cost(s):
            px, py, th, v = s
            dx, dy, dv = px - gx, py - gy, v - v_ref
            return w_pos * (dx * dx + dy * dy) + w_vel * dv * dv

        def carry0():
            return tuple(
                jnp.broadcast_to(p(7 + i), (plan.block,)) for i in range(4)
            )

        def step(state, acts):
            acc, steer = acts
            tan_d = jnp.sin(steer) / jnp.cos(steer)
            # RK2 midpoint — mirrors BicycleDynamics.step exactly
            d1 = deriv(state, acc, tan_d)
            s_m = tuple(state[i] + 0.5 * dt * d1[i] for i in range(4))
            d2 = deriv(s_m, acc, tan_d)
            state = tuple(state[i] + dt * d2[i] for i in range(4))
            return state, state_cost(state)

        return carry0, step, state_cost


# ---------------------------------------------------------------------------
# demo: receding-horizon drive to a waypoint, model-as-world.
# ---------------------------------------------------------------------------


def make_controller(samples: int, horizon: int = 40, backend: str = "auto"):
    cfg = MPPIConfig(
        env="bicycle-demo", samples=samples, state_dim=4, action_dim=2,
        horizon=horizon, dt=0.05, lambda_=0.4,
        noise=(0.8, 0.5), init_act=(0.0, 0.0), max_a=(2.0, 0.6),
        goal=(3.0, 1.5, 0.0, 0.0), cost_w=(1.0, 1.0, 0.0, 0.0),
    )
    dyn = BicycleDynamics.create(cfg.dt)
    cost = BicycleWaypointCost(
        # v_ref=0: the speed term doubles as a brake, parking the car at the
        # waypoint instead of cruising past it
        w=jnp.asarray([2.0, 0.3]), goal=jnp.asarray([3.0, 1.5]),
        v_ref=jnp.float32(0.0), lambda_=jnp.float32(cfg.lambda_),
        inv_s=jnp.asarray([1.0, 1.0]),
    )
    return MPPIController(cfg, dyn, cost, rollout_backend=backend), dyn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "scan", "pallas", "pallas-interpret"))
    args = p.parse_args(argv)

    ctrl, dyn = make_controller(args.samples, backend=args.backend)
    print(f"backend resolved: {ctrl.rollout_backend}")
    x = jnp.asarray([0.0, 0.0, 0.0, 0.0])
    U = ctrl.init_action_seq()
    key = ctrl.init_key()
    for step in range(args.steps):
        res = ctrl.solve_auto(x, U, key, step)
        x, U = dyn.step(x, res.action), res.u_next
    px, py = float(x[0]), float(x[1])
    d = ((px - 3.0) ** 2 + (py - 1.5) ** 2) ** 0.5
    print(f"final pose ({px:.3f}, {py:.3f})  dist-to-waypoint {d:.3f} m")
    ok = d < 0.3
    print("reached waypoint" if ok else "did NOT reach waypoint")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
