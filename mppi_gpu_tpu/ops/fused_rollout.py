"""Fused MPPI rollout kernels for NVIDIA GPUs (Pallas, Triton route).

The reference rolls out with one CUDA thread per rollout: a per-thread
cuRAND state, the T-step loop inside the thread, one cost written per
rollout (reference src/point_mass.cu:493-508). The two kernels here keep that
shape and drop the reference's ε buffer:

* **Kernel A** (:func:`fused_costs`) — grid over blocks of rollouts, one
  rollout per lane of a ``(BLOCK,)`` vector. Inside, a ``fori_loop`` over T
  draws ε from the counter-based generator (ops/noise.py), reads ``U[t]``
  as scalars, steps the family's dynamics on per-component vectors and
  accumulates the cost in registers. It writes only S, 4 bytes a rollout.
* The softmin (β, η, weights) and the clamp stay in XLA, with ``pmin`` /
  ``psum`` across a mesh.
* **Kernel B** (:func:`fused_update`) — regenerates the same ε, weights it
  per rollout and reduces ``Σ_k w_k ε_k[t]`` over its block. It writes
  ``(blocks, T, a)`` partial sums that XLA adds up: no atomics, so the
  result is deterministic.

The (T, K, a) noise tensor never exists in device memory. A fleet of R
robots is a leading grid axis of both kernels (per-robot key, U and
parameter row). Every ``pallas_call`` names ``backend="triton"``;
``interpret=True`` runs the same kernels on the CPU for tests.

A *family* teaches the kernels one (dynamics, cost) pair through
``pack_planar``/``build_planar`` over ``(BLOCK,)`` vectors; see
:func:`register_family`. Each family mirrors its scan-path ``Dynamics.step``
and cost, so the kernels agree with the plain reference
(:func:`mppi_gpu_tpu.controller.mppi_solve_deterministic` fed
:func:`mppi_gpu_tpu.ops.noise.noise_tensor`) to f32 rounding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from mppi_gpu_tpu.ops.cost import QuadraticCost
from mppi_gpu_tpu.ops.noise import key_words, mirror, normals, ou_coefficients

# Block sizes: powers of two (Triton), one rollout per thread.
BLOCK_MIN, BLOCK_MAX = 32, 256
# Blocks wanted in flight before a block grows past BLOCK_MIN: two per SM
# of an H100 (132 SMs). Small K then spreads over the SMs instead of
# filling a few of them.
_TARGET_BLOCKS = 264


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class Plan(NamedTuple):
    """Static geometry shared by kernels A and B."""

    K: int          # rollouts per robot
    T: int
    A: int          # action dim
    R: int          # robots (grid axis 0)
    block: int      # rollouts per block (a power of two)
    antithetic: bool
    ou_beta: float
    family: str
    extra: int = 0  # family-specific static size (obstacle count)

    @property
    def n_blocks(self) -> int:
        return -(-self.K // self.block)

    @property
    def Kpad(self) -> int:
        return self.n_blocks * self.block

    @property
    def num_warps(self) -> int:
        return max(1, self.block // 32)


def pick_block(K: int, R: int = 1) -> int:
    """Block size for R·K rollouts: the smallest power of two in
    [BLOCK_MIN, BLOCK_MAX] that keeps the grid near _TARGET_BLOCKS."""
    want = _pow2_ceil(-(-(R * K) // _TARGET_BLOCKS))
    return min(BLOCK_MAX, max(BLOCK_MIN, want))


def make_plan(
    K: int, T: int, action_dim: int, *, R: int = 1, antithetic: bool = False,
    ou_beta: float = 0.0, family: str = "lti", extra: int = 0,
) -> Plan:
    if antithetic and K % 2:
        raise ValueError(f"antithetic sampling needs even K, got {K}")
    if family not in FAMILIES:
        raise ValueError(f"unknown fused family '{family}'; known: {sorted(FAMILIES)}")
    return Plan(
        K=K, T=T, A=action_dim, R=R, block=pick_block(K, R),
        antithetic=antithetic, ou_beta=float(ou_beta), family=family,
        extra=extra,
    )


# --------------------------------------------------------------------------
# Families. `pack_planar(dyn, cost, x0)` returns the (n,) f32 parameter row;
# `build_planar(p, dt, plan)` returns (carry0, step, final) closures over
# (plan.block,) vectors, where `p(i)` reads parameter i as a scalar.
# --------------------------------------------------------------------------


def sincos_small(x):
    """(sin x, cos x) of a SMALL angle as degree-7/8 Taylor polynomials — no
    range reduction. The trig-carry families below advance a carried
    (sin θ, cos θ) by per-step half-increments δ that are small by
    construction: rates are saturated (arm: |δ| ≤ 0.2) or noise-capped (the
    Box-Muller radius of a 23-bit uniform is at most √(46·ln 2) ≈ 5.65σ).
    Truncation error ≤ |x|⁹/9! and |x|¹⁰/10!: at |x| = 0.5 that is below
    one f32 ulp of the result. A rollout already diverging past |x| ≈ 1 gets
    a huge cost and zero softmin weight, as with true trig."""
    x2 = x * x
    s = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 * (-1.0 / 5040.0))))
    c = 1.0 + x2 * (
        -0.5 + x2 * (1.0 / 24.0 + x2 * (-1.0 / 720.0 + x2 * (1.0 / 40320.0)))
    )
    return s, c


def _rot(s, c, s_d, c_d):
    """Angle addition: trig of (θ + δ) from trig of θ and of δ."""
    return s * c_d + c * s_d, c * c_d - s * s_d


def _scalars(*vals) -> jax.Array:
    return jnp.stack([jnp.asarray(v, jnp.float32).reshape(()) for v in vals])


def _bcast(plan: Plan):
    return lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), (plan.block,))


class _LTIFamily:
    """Analytic LTI double integrator + quadratic cost — the reference's own
    model (src/point_mass_gpu.cu:97-106, src/cost.cu:42-64). State (q, qd),
    one vector per position and per velocity component."""

    name = "lti"  # parameters: wq, wqd, gq, gqd, x0q, x0qd — A each

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.point_mass import PointMassLTI

        return isinstance(dyn, PointMassLTI) and type(cost) is QuadraticCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        A = dyn.action_dim
        w, g = cost.w.astype(jnp.float32), cost.goal.astype(jnp.float32)
        x0 = jnp.broadcast_to(x0, (2 * A,)).astype(jnp.float32)
        return jnp.concatenate([w[:A], w[A:], g[:A], g[A:], x0[:A], x0[A:]])

    @staticmethod
    def build_planar(p, dt, plan):
        A = plan.A
        bc = _bcast(plan)
        wq, wqd = [p(i) for i in range(A)], [p(A + i) for i in range(A)]
        gq, gqd = [p(2 * A + i) for i in range(A)], [p(3 * A + i) for i in range(A)]
        hdt2 = 0.5 * dt * dt

        def state_cost(q, qd):
            c = None
            for i in range(A):
                dq, dqd = q[i] - gq[i], qd[i] - gqd[i]
                ci = wq[i] * dq * dq + wqd[i] * dqd * dqd
                c = ci if c is None else c + ci
            return c

        def carry0():
            return (
                tuple(bc(p(4 * A + i)) for i in range(A)),
                tuple(bc(p(5 * A + i)) for i in range(A)),
            )

        def step(state, acts):
            q, qd = state
            # LTI point-mass integrate (reference src/point_mass_gpu.cu:97-106)
            q2 = tuple(q[i] + dt * qd[i] + hdt2 * acts[i] for i in range(A))
            qd2 = tuple(qd[i] + dt * acts[i] for i in range(A))
            return (q2, qd2), state_cost(q2, qd2)

        def final(state):
            # the terminal cost re-counts x_T (reference parity, src/cost.cu:57-64)
            return state_cost(*state)

        return carry0, step, final


class _LTIObstacleFamily:
    """LTI point mass + spherical-obstacle penalty (ops/cost.py ObstacleCost).
    The obstacle count M is static (plan.extra), so the kernel carries
    exactly M obstacle terms."""

    name = "lti-obstacle"  # the lti parameters, penalty, (center, r²) each

    @staticmethod
    def plan_extra(cost) -> int:
        return int(cost.centers.shape[0])

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.point_mass import PointMassLTI
        from mppi_gpu_tpu.ops.cost import ObstacleCost

        return (
            isinstance(dyn, PointMassLTI)
            and type(cost) is ObstacleCost
            and type(cost.base) is QuadraticCost
            # obstacles live in position space, one coord per action dim
            and cost.centers.shape[-1] == dyn.action_dim
        )

    @staticmethod
    def pack_planar(dyn, cost, x0):
        base = _LTIFamily.pack_planar(dyn, cost.base, x0)
        obs = jnp.concatenate(
            [cost.centers.astype(jnp.float32), (cost.radii**2)[:, None]], axis=1
        ).reshape(-1)  # per obstacle: center (A), radius²
        return jnp.concatenate([base, _scalars(cost.penalty), obs])

    @staticmethod
    def build_planar(p, dt, plan):
        A, M = plan.A, plan.extra
        carry0, lti_step, lti_final = _LTIFamily.build_planar(p, dt, plan)
        off = 6 * A
        pen = p(off)

        def obstacle_cost(q):
            hits = None
            for m in range(M):
                o = off + 1 + m * (A + 1)
                d2 = None
                for i in range(A):
                    d = q[i] - p(o + i)
                    d2 = d * d if d2 is None else d2 + d * d
                hit = (d2 < p(o + A)).astype(jnp.float32)
                hits = hit if hits is None else hits + hit
            return pen * hits

        def step(state, acts):
            state, c = lti_step(state, acts)
            return state, c + obstacle_cost(state[0])

        def final(state):
            return lti_final(state) + obstacle_cost(state[0])

        return carry0, step, final


class _PendulumFamily:
    """Torque-limited pendulum swing-up (models/pendulum.py, ops/cost.py
    PendulumSwingupCost): RK2 midpoint of θ̈ = (g/l) sin θ + u/(m l²) − b θ̇.
    The carry holds (θ̇, sin θ, cos θ); θ advances by small-angle
    additions (:func:`sincos_small`), so a step needs no transcendental."""

    name = "pendulum"
    # parameters: w_angle, w_vel, x0_th, x0_thd, g/l, 1/(m l²), b

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.pendulum import PendulumDynamics
        from mppi_gpu_tpu.ops.cost import PendulumSwingupCost

        return isinstance(dyn, PendulumDynamics) and type(cost) is PendulumSwingupCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (2,)).astype(jnp.float32)
        return _scalars(
            cost.w_angle, cost.w_vel, x0[0], x0[1],
            dyn.gravity / dyn.length, 1.0 / (dyn.mass * dyn.length**2),
            dyn.damping,
        )

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w_ang, w_vel, gl, iml2, damp = p(0), p(1), p(4), p(5), p(6)

        def accel(s_th, thd, u):
            return gl * s_th + iml2 * u - damp * thd

        def state_cost(c_th, thd):
            return w_ang * (1.0 - c_th) + w_vel * thd * thd

        def carry0():
            th = bc(p(2))
            return (bc(p(3)), jnp.sin(th), jnp.cos(th))

        def step(state, acts):
            thd, s_th, c_th = state
            (u,) = acts
            # RK2 midpoint — θm = θ + δ1, θ' = θm + δ2 by angle addition
            k1 = accel(s_th, thd, u)
            s_m, c_m = _rot(s_th, c_th, *sincos_small(0.5 * dt * thd))
            thd_m = thd + 0.5 * dt * k1
            k2 = accel(s_m, thd_m, u)
            s_th, c_th = _rot(
                s_m, c_m, *sincos_small(0.5 * dt * thd + 0.5 * dt * dt * k1)
            )
            thd = thd + dt * k2
            return (thd, s_th, c_th), state_cost(c_th, thd)

        def final(state):
            thd, _, c_th = state
            return state_cost(c_th, thd)

        return carry0, step, final


class _CartPoleFamily:
    """Cart-pole balance (models/cartpole.py, ops/cost.py
    CartPoleBalanceCost): RK2 midpoint of the coupled cart-pole ODE. The
    carry holds (p, sin θ, cos θ, ṗ, θ̇); two divides a stage remain."""

    name = "cartpole"
    # parameters: w0..w3, x0 (4), m_p·l, 1/(m_c+m_p), m_p/(m_c+m_p), l, g

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.cartpole import CartPoleDynamics
        from mppi_gpu_tpu.ops.cost import CartPoleBalanceCost

        return isinstance(dyn, CartPoleDynamics) and type(cost) is CartPoleBalanceCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (4,)).astype(jnp.float32)
        w = cost.w.astype(jnp.float32)
        total = dyn.cart_mass + dyn.pole_mass
        return jnp.concatenate([w, x0, _scalars(
            dyn.pole_mass * dyn.pole_length, 1.0 / total,
            dyn.pole_mass / total, dyn.pole_length, dyn.gravity,
        )])

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w0, w1, w2, w3 = p(0), p(1), p(2), p(3)
        mpl, inv_tot, mp_frac, l, g = p(8), p(9), p(10), p(11), p(12)

        def accel(s, c, thd, u):
            # (p̈, θ̈) — mirrors CartPoleDynamics.accel on precomputed trig
            a = (u + mpl * thd * thd * s) * inv_tot
            thdd = (g * s - c * a) / (l * (4.0 / 3.0 - mp_frac * c * c))
            pdd = a - mpl * thdd * c * inv_tot
            return pdd, thdd

        def state_cost(x, c_th, pd, thd):
            return w0 * x * x + w1 * (1.0 - c_th) + w2 * pd * pd + w3 * thd * thd

        def carry0():
            th = bc(p(5))
            return (bc(p(4)), jnp.sin(th), jnp.cos(th), bc(p(6)), bc(p(7)))

        def step(state, acts):
            x, s_th, c_th, pd, thd = state
            (u,) = acts
            # RK2 midpoint — mirrors CartPoleDynamics.step
            pdd1, thdd1 = accel(s_th, c_th, thd, u)
            d1 = 0.5 * dt * thd
            s_m, c_m = _rot(s_th, c_th, *sincos_small(d1))
            thd_m = thd + 0.5 * dt * thdd1
            pdd2, thdd2 = accel(s_m, c_m, thd_m, u)
            s_th, c_th = _rot(s_m, c_m, *sincos_small(d1 + 0.5 * dt * dt * thdd1))
            x = x + dt * (pd + 0.5 * dt * pdd1)
            pd = pd + dt * pdd2
            thd = thd + dt * thdd2
            return (x, s_th, c_th, pd, thd), state_cost(x, c_th, pd, thd)

        def final(state):
            x, _, c_th, pd, thd = state
            return state_cost(x, c_th, pd, thd)

        return carry0, step, final


class _QuadrotorFamily:
    """Planar quadrotor in mixer action space (models/quadrotor.py,
    ops/cost.py QuadrotorHoverCost): RK2 midpoint of the birotor ODE. The
    carry holds (px, pz, sin θ, cos θ, vx, vz, ω)."""

    name = "quadrotor"
    # parameters: w (6), goal x/z, x0 (6), 1/m, r/I, g

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.quadrotor import QuadrotorDynamics
        from mppi_gpu_tpu.ops.cost import QuadrotorHoverCost

        return isinstance(dyn, QuadrotorDynamics) and type(cost) is QuadrotorHoverCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (6,)).astype(jnp.float32)
        return jnp.concatenate([
            cost.w.astype(jnp.float32), cost.goal[:2].astype(jnp.float32), x0,
            _scalars(1.0 / dyn.mass, dyn.arm / dyn.inertia, dyn.gravity),
        ])

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w = [p(i) for i in range(6)]
        gx, gz = p(6), p(7)
        im, ri, grav = p(14), p(15), p(16)

        def accels(s_th, c_th, F, D):
            # mirrors QuadrotorDynamics.accels on precomputed trig
            return F * s_th * im, F * c_th * im - grav, ri * D

        def state_cost(s):
            px, pz, _, c_th, vx, vz, om = s
            dx, dz = px - gx, pz - gz
            return (
                w[0] * dx * dx + w[1] * dz * dz + w[2] * (1.0 - c_th)
                + w[3] * vx * vx + w[4] * vz * vz + w[5] * om * om
            )

        def carry0():
            x = [bc(p(8 + i)) for i in range(6)]
            return (x[0], x[1], jnp.sin(x[2]), jnp.cos(x[2]), x[3], x[4], x[5])

        def step(state, acts):
            px, pz, s_th, c_th, vx, vz, om = state
            F, D = acts
            # RK2 midpoint — mirrors QuadrotorDynamics.step
            ax1, az1, al1 = accels(s_th, c_th, F, D)
            d1 = 0.5 * dt * om
            s_m, c_m = _rot(s_th, c_th, *sincos_small(d1))
            ax2, az2, al2 = accels(s_m, c_m, F, D)
            s_n, c_n = _rot(s_m, c_m, *sincos_small(d1 + 0.5 * dt * dt * al1))
            state = (
                px + dt * (vx + 0.5 * dt * ax1),
                pz + dt * (vz + 0.5 * dt * az1),
                s_n, c_n,
                vx + dt * ax2, vz + dt * az2, om + dt * al2,
            )
            return state, state_cost(state)

        return carry0, step, state_cost


class _UnicycleFamily:
    """Differential-drive unicycle + waypoint cost (models/unicycle.py,
    ops/cost.py UnicycleWaypointCost): RK2 midpoint of the planar-pose
    kinematics. The carry holds (px, py, sin θ, cos θ); a step needs one
    rsqrt and no other transcendental."""

    name = "unicycle"
    # parameters: w_pos, w_head, gx, gy, x0 px/py/θ

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.unicycle import UnicycleDynamics
        from mppi_gpu_tpu.ops.cost import UnicycleWaypointCost

        return isinstance(dyn, UnicycleDynamics) and type(cost) is UnicycleWaypointCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (3,)).astype(jnp.float32)
        return jnp.concatenate([
            cost.w.astype(jnp.float32), cost.goal[:2].astype(jnp.float32), x0,
        ])

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w_pos, w_head, gx, gy = p(0), p(1), p(2), p(3)

        def state_cost(px, py, s_th, c_th):
            # mirrors UnicycleWaypointCost._state (incl. the 1e-3 ε)
            dx, dy = gx - px, gy - py
            d2 = dx * dx + dy * dy
            align = (dx * c_th + dy * s_th) * jax.lax.rsqrt(d2 + 1e-3)
            return w_pos * d2 + w_head * (1.0 - align)

        def carry0():
            th = bc(p(6))
            return (bc(p(4)), bc(p(5)), jnp.sin(th), jnp.cos(th))

        def step(state, acts):
            px, py, s_th, c_th = state
            v, om = acts
            # RK2 midpoint: θm = θ + δ, θ' = θm + δ with δ = ω·dt/2
            s_d, c_d = sincos_small(0.5 * dt * om)
            s_m, c_m = _rot(s_th, c_th, s_d, c_d)
            s_n, c_n = _rot(s_m, c_m, s_d, c_d)
            state = (px + dt * v * c_m, py + dt * v * s_m, s_n, c_n)
            return state, state_cost(*state)

        def final(state):
            return state_cost(*state)

        return carry0, step, final


class _ArmFamily:
    """Two-link planar manipulator + reach cost (models/arm.py, ops/cost.py
    ArmReachCost): RK2 midpoint of the manipulator equations with the
    closed-form 2×2 mass-matrix inverse and joint-rate saturation after
    each stage. The joint angles are carried as trig only, advanced by
    small-angle additions (|δ| ≤ max_rate·dt by the saturation)."""

    name = "arm"
    # parameters: w_pos, w_vel, tx, ty, A, B, D, G1, G2, damping, max_rate, l1, l2, x0 (4)

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.arm import TwoLinkArmDynamics
        from mppi_gpu_tpu.ops.cost import ArmReachCost

        return isinstance(dyn, TwoLinkArmDynamics) and type(cost) is ArmReachCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (4,)).astype(jnp.float32)
        return jnp.concatenate([
            cost.w.astype(jnp.float32), cost.goal[:2].astype(jnp.float32),
            _scalars(dyn.A, dyn.B, dyn.D, dyn.G1, dyn.G2, dyn.damping,
                     dyn.max_rate,
                     # FK link lengths come from the COST, as in ArmReachCost
                     cost.l1, cost.l2),
            x0,
        ])

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w_pos, w_vel, tx, ty = p(0), p(1), p(2), p(3)
        A_, B_, D_, g1, g2, damp, maxr, l1, l2 = (p(4 + i) for i in range(9))

        def deriv(qd1, qd2, t1, t2, trig):
            # mirrors TwoLinkArmDynamics._deriv; cos(q1+q2) by angle addition
            s1, c1, s2, c2 = trig
            c12 = c1 * c2 - s1 * s2
            d11 = A_ + 2.0 * B_ * c2
            d12 = D_ + B_ * c2
            hs = B_ * s2
            r1 = t1 + hs * (2.0 * qd1 * qd2 + qd2 * qd2) \
                - (g1 * c1 + g2 * c12) - damp * qd1
            r2 = t2 - hs * qd1 * qd1 - g2 * c12 - damp * qd2
            inv_det = 1.0 / (d11 * D_ - d12 * d12)
            return (D_ * r1 - d12 * r2) * inv_det, (d11 * r2 - d12 * r1) * inv_det

        def sat(qd):
            return jnp.clip(qd, -maxr, maxr)

        def state_cost(qd1, qd2, trig):
            s1, c1, s2, c2 = trig
            s12, c12 = _rot(s1, c1, s2, c2)
            dx = l1 * c1 + l2 * c12 - tx
            dy = l1 * s1 + l2 * s12 - ty
            return w_pos * (dx * dx + dy * dy) + w_vel * (qd1 * qd1 + qd2 * qd2)

        def carry0():
            q = [bc(p(13 + i)) for i in range(4)]
            return (q[2], q[3], jnp.sin(q[0]), jnp.cos(q[0]),
                    jnp.sin(q[1]), jnp.cos(q[1]))

        def step(state, acts):
            qd1, qd2, s1, c1, s2, c2 = state
            t1, t2 = acts
            trig = (s1, c1, s2, c2)
            # RK2 midpoint + rate saturation — mirrors TwoLinkArmDynamics.step
            qdd1, qdd2 = deriv(qd1, qd2, t1, t2, trig)
            trig_m = (*_rot(s1, c1, *sincos_small(0.5 * dt * qd1)),
                      *_rot(s2, c2, *sincos_small(0.5 * dt * qd2)))
            qd1m = sat(qd1 + 0.5 * dt * qdd1)
            qd2m = sat(qd2 + 0.5 * dt * qdd2)
            qdd1m, qdd2m = deriv(qd1m, qd2m, t1, t2, trig_m)
            trig_n = (*_rot(s1, c1, *sincos_small(dt * qd1m)),
                      *_rot(s2, c2, *sincos_small(dt * qd2m)))
            qd1n = sat(qd1 + dt * qdd1m)
            qd2n = sat(qd2 + dt * qdd2m)
            return (qd1n, qd2n, *trig_n), state_cost(qd1n, qd2n, trig_n)

        def final(state):
            return state_cost(state[0], state[1], state[2:])

        return carry0, step, final


class _Quadrotor3DFamily:
    """Full 3-D quadrotor, quaternion rigid body in mixer action space
    (models/quadrotor3d.py, ops/cost.py Quadrotor3DHoverCost): RK2 midpoint
    of the 13-state ODE. Polynomial plus one rsqrt (quaternion renorm)."""

    name = "quadrotor3d"
    # parameters: w (8), goal p (3), goal v (3), x0 (13), 1/m, g, 1/J (3), J diffs (3)

    @staticmethod
    def supports(dyn, cost) -> bool:
        from mppi_gpu_tpu.models.quadrotor3d import Quadrotor3DDynamics
        from mppi_gpu_tpu.ops.cost import Quadrotor3DHoverCost

        return isinstance(dyn, Quadrotor3DDynamics) and type(cost) is Quadrotor3DHoverCost

    @staticmethod
    def pack_planar(dyn, cost, x0):
        x0 = jnp.broadcast_to(x0, (13,)).astype(jnp.float32)
        g = cost.goal.astype(jnp.float32)
        jx, jy, jz = dyn.inertia[0], dyn.inertia[1], dyn.inertia[2]
        return jnp.concatenate([
            cost.w.astype(jnp.float32), g[0:3], g[7:10], x0,
            _scalars(1.0 / dyn.mass, dyn.gravity, 1.0 / jx, 1.0 / jy, 1.0 / jz,
                     jz - jy, jx - jz, jy - jx),
        ])

    @staticmethod
    def build_planar(p, dt, plan):
        bc = _bcast(plan)
        w = [p(i) for i in range(8)]
        gp = [p(8 + i) for i in range(3)]
        gv = [p(11 + i) for i in range(3)]
        im, grav = p(27), p(28)
        ij = [p(29 + i) for i in range(3)]
        cj = [p(32 + i) for i in range(3)]

        def derivs(q, om, F, TX, TY, TZ):
            # mirrors Quadrotor3DDynamics.derivs (reciprocals pre-packed)
            qw, qx, qy, qz = q
            wx, wy, wz = om
            fm = F * im
            acc = (
                2.0 * (qx * qz + qw * qy) * fm,
                2.0 * (qy * qz - qw * qx) * fm,
                (1.0 - 2.0 * (qx * qx + qy * qy)) * fm - grav,
            )
            qdot = (
                -0.5 * (qx * wx + qy * wy + qz * wz),
                0.5 * (qw * wx + qy * wz - qz * wy),
                0.5 * (qw * wy + qz * wx - qx * wz),
                0.5 * (qw * wz + qx * wy - qy * wx),
            )
            omdot = (
                (TX - cj[0] * wy * wz) * ij[0],
                (TY - cj[1] * wz * wx) * ij[1],
                (TZ - cj[2] * wx * wy) * ij[2],
            )
            return qdot, acc, omdot

        def state_cost(s):
            p_, q, v, om = s[0:3], s[3:7], s[7:10], s[10:13]
            c = None
            for i in range(3):
                dp, dv = p_[i] - gp[i], v[i] - gv[i]
                ci = w[i] * dp * dp + w[4 + i] * dv * dv
                c = ci if c is None else c + ci
            c = c + w[3] * (2.0 * (q[1] * q[1] + q[2] * q[2]))
            return c + w[7] * (om[0] * om[0] + om[1] * om[1] + om[2] * om[2])

        def carry0():
            return tuple(bc(p(14 + i)) for i in range(13))

        def step(state, acts):
            p_, q, v, om = state[0:3], state[3:7], state[7:10], state[10:13]
            F, TX, TY, TZ = acts
            # RK2 midpoint — mirrors Quadrotor3DDynamics.step
            qd1, a1, wd1 = derivs(q, om, F, TX, TY, TZ)
            q_m = tuple(q[i] + 0.5 * dt * qd1[i] for i in range(4))
            v_m = tuple(v[i] + 0.5 * dt * a1[i] for i in range(3))
            om_m = tuple(om[i] + 0.5 * dt * wd1[i] for i in range(3))
            qd2, a2, wd2 = derivs(q_m, om_m, F, TX, TY, TZ)
            q_n = tuple(q[i] + dt * qd2[i] for i in range(4))
            inv = jax.lax.rsqrt(
                q_n[0] * q_n[0] + q_n[1] * q_n[1] + q_n[2] * q_n[2] + q_n[3] * q_n[3]
            )
            state = (
                *(p_[i] + dt * v_m[i] for i in range(3)),
                *(q_n[i] * inv for i in range(4)),
                *(v[i] + dt * a2[i] for i in range(3)),
                *(om[i] + dt * wd2[i] for i in range(3)),
            )
            return state, state_cost(state)

        return carry0, step, state_cost


FAMILIES = {
    f.name: f
    for f in (
        _LTIFamily, _PendulumFamily, _CartPoleFamily, _LTIObstacleFamily,
        _QuadrotorFamily, _Quadrotor3DFamily, _UnicycleFamily, _ArmFamily,
    )
}
_BUILTIN_FAMILIES = frozenset(FAMILIES)


def register_family(cls):
    """Register an out-of-tree fused (dynamics, cost) family (usable as a
    class decorator). After registration the ``'auto'`` backend resolves
    the pair to the fused kernels on a GPU like the eight built-in ones.

    A family contributes only the per-step dynamics and state cost; noise,
    the nominal actions, the control cost term, padding, the weighted
    update, fleets and meshes are shared machinery. Protocol (worked
    example: examples/custom_family.py; docs/extending.md §3):

    * ``name: str`` — unique family name.
    * ``supports(dyn, cost) -> bool`` — first matching family wins.
    * ``pack_planar(dyn, cost, x0) -> (n,) f32`` — the parameter row, built
      (traced) once per solve; per robot in a fleet.
    * ``build_planar(p, dt, plan) -> (carry0, step, final)`` — closures over
      ``(plan.block,)`` f32 vectors, one rollout per lane. ``p(i)`` is
      parameter ``i`` as a scalar and ``dt`` the dynamics' step. ``carry0()``
      returns the initial state as a tuple of vectors; ``step(state, acts)``
      takes the A effective actions ``u_t + ε_t`` as a list of vectors and
      returns ``(state', c)`` with ``c`` the state cost of ``x_{t+1}`` (the
      shared code adds the ``λ·uᵀΣ⁻¹ε`` term); ``final(state)`` returns the
      terminal cost. ``step`` must mirror the scan-path ``Dynamics.step`` so
      that the kernels agree with the plain reference.

    Optional: ``plan_extra(cost) -> int``, a static per-cost size stored as
    ``plan.extra``. Overriding a built-in name raises ValueError;
    re-registering a user family replaces it.
    """
    for attr in ("name", "supports", "pack_planar", "build_planar"):
        if not hasattr(cls, attr):
            raise TypeError(f"fused family {cls!r} lacks required attribute '{attr}'")
    if not isinstance(cls.name, str) or not cls.name:
        raise TypeError(f"fused family {cls!r}: 'name' must be a non-empty str")
    if cls.name in _BUILTIN_FAMILIES:
        raise ValueError(f"cannot override built-in fused family '{cls.name}'")
    FAMILIES[cls.name] = cls
    return cls


def unregister_family(name: str) -> None:
    """Remove a user-registered family. Built-ins are permanent."""
    if name in _BUILTIN_FAMILIES:
        raise ValueError(f"cannot unregister built-in fused family '{name}'")
    FAMILIES.pop(name, None)


def family_for(dyn, cost) -> str:
    """Fused-family name for a (dynamics, cost) pair, or TypeError."""
    for fam in FAMILIES.values():
        if fam.supports(dyn, cost):
            return fam.name
    raise TypeError(
        "the fused kernels cover "
        + ", ".join(f"({f.name})" for f in FAMILIES.values())
        + f"; got ({type(dyn).__name__}, {type(cost).__name__}) — use "
        "rollout_backend='scan' for custom models"
    )


def plan_for(dyn, cost, K: int, T: int, action_dim: int, *, R: int = 1,
             antithetic: bool = False, ou_beta: float = 0.0) -> Plan:
    name = family_for(dyn, cost)
    fam = FAMILIES[name]
    extra = fam.plan_extra(cost) if hasattr(fam, "plan_extra") else 0
    return make_plan(K, T, action_dim, R=R, antithetic=antithetic,
                     ou_beta=ou_beta, family=name, extra=extra)


# --------------------------------------------------------------------------
# Kernels
# --------------------------------------------------------------------------

# Parameter row layout: [dt, σ (A), λ·Σ⁻¹ (A), the family's parameters].
def _row_reader(p_ref, r, plan: Plan):
    A = plan.A
    p = lambda i: p_ref[r, i]  # noqa: E731
    return p(0), [p(1 + d) for d in range(A)], [p(1 + A + d) for d in range(A)], (
        lambda i: p(1 + 2 * A + i)
    )


def _block_ids(plan: Plan):
    b = pl.program_id(1)
    ids = b * plan.block + jnp.arange(plan.block, dtype=jnp.int32)
    base, sign = mirror(ids, plan.K, plan.antithetic)
    return ids, base, sign


def _unit_noise(k0, k1, base, t, e_prev, plan: Plan):
    """Step t's unit-variance noise per action dim (OU recursion applied)."""
    nu = normals(k0, k1, base, t, plan.A)
    if plan.ou_beta <= 0.0:
        return nu
    cp, cn = ou_coefficients(t, plan.ou_beta)
    return [cp * e + cn * n for e, n in zip(e_prev, nu)]


def _costs_kernel(words_ref, u_ref, p_ref, s_ref, *, plan: Plan):
    """Kernel A: one block of rollouts → its costs S."""
    A = plan.A
    r = pl.program_id(0)
    ids, base, sign = _block_ids(plan)
    k0, k1 = words_ref[r, 0], words_ref[r, 1]
    dt, sigma, lam_invs, fam_p = _row_reader(p_ref, r, plan)
    scale = [sign * s for s in sigma]
    carry0, fam_step, fam_final = FAMILIES[plan.family].build_planar(fam_p, dt, plan)

    def body(t, carry):
        state, acc, e_prev = carry
        e = _unit_noise(k0, k1, base, t, e_prev, plan)
        acts = []
        for d in range(A):
            eps = scale[d] * e[d]
            u = u_ref[r, t, d]
            acc = acc + (lam_invs[d] * u) * eps
            acts.append(u + eps)
        state, c = fam_step(state, acts)
        return state, acc + c, tuple(e)

    zero = jnp.zeros((plan.block,), jnp.float32)
    state, acc, _ = jax.lax.fori_loop(
        0, plan.T, body, (carry0(), zero, (zero,) * A)
    )
    acc = acc + fam_final(state)
    # padded rollouts cost +inf: their softmin weight is exactly 0
    s_ref[r, pl.ds(pl.program_id(1) * plan.block, plan.block)] = jnp.where(
        ids < plan.K, acc, jnp.inf
    )


def _update_kernel(words_ref, p_ref, w_ref, du_ref, *, plan: Plan):
    """Kernel B: regenerate one block's ε and reduce Σ_k w_k ε_k[t] over the
    block, for every (t, d)."""
    A = plan.A
    r, b = pl.program_id(0), pl.program_id(1)
    _, base, sign = _block_ids(plan)
    k0, k1 = words_ref[r, 0], words_ref[r, 1]
    _, sigma, _, _ = _row_reader(p_ref, r, plan)
    w = w_ref[r, pl.ds(b * plan.block, plan.block)] * sign

    def body(t, e_prev):
        e = _unit_noise(k0, k1, base, t, e_prev, plan)
        for d in range(A):
            du_ref[r, b, t, d] = sigma[d] * jnp.sum(w * e[d])
        return tuple(e)

    zero = jnp.zeros((plan.block,), jnp.float32)
    jax.lax.fori_loop(0, plan.T, body, (zero,) * A)


def _call(kernel, plan: Plan, out_shape, interpret: bool):
    return pl.pallas_call(
        functools.partial(kernel, plan=plan),
        out_shape=out_shape,
        grid=(plan.R, plan.n_blocks),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=plan.num_warps, num_stages=1),
        interpret=interpret,
    )


def pack_rows(dyn, cost, xs, sigma, plan: Plan, cost_axes=None) -> jax.Array:
    """(R, 1 + 2A + n) f32 parameter rows, one per robot. `cost_axes` is
    the vmap in_axes pytree of a cost whose leaves carry a robot axis
    (per-robot goals), None when the cost is shared."""
    fam = FAMILIES[plan.family]
    sig = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), (plan.A,))

    def row(c, x0):
        lam_invs = jnp.broadcast_to(
            c.lambda_ * c.inv_s, (plan.A,)
        ).astype(jnp.float32)
        return jnp.concatenate([
            jnp.asarray(dyn.dt, jnp.float32).reshape(1), sig, lam_invs,
            fam.pack_planar(dyn, c, x0).astype(jnp.float32),
        ])

    if cost_axes is None:
        cost_axes = jax.tree_util.tree_map(lambda _: None, cost)
    return jax.vmap(row, in_axes=(cost_axes, 0))(cost, xs)


def fused_costs(words, Us, rows, plan: Plan, *, interpret: bool = False):
    """Kernel A over R robots: (R, 2) uint32 key words, (R, T, A) nominal
    sequences, (R, ·) parameter rows → S (R, Kpad), +inf past K."""
    return _call(
        _costs_kernel, plan,
        jax.ShapeDtypeStruct((plan.R, plan.Kpad), jnp.float32), interpret,
    )(words, Us.astype(jnp.float32), rows)


def fused_update(words, rows, weights, plan: Plan, *, interpret: bool = False):
    """Kernel B over R robots: softmin weights (R, Kpad) → ΔU (R, T, A). The
    per-block partial sums are added up here, in XLA."""
    part = _call(
        _update_kernel, plan,
        jax.ShapeDtypeStruct((plan.R, plan.n_blocks, plan.T, plan.A), jnp.float32),
        interpret,
    )(words, rows, weights)
    return jnp.sum(part, axis=1)


def robot_words(keys: jax.Array) -> jax.Array:
    """(R,) keys → (R, 2) uint32 generator words."""
    return jax.vmap(key_words)(keys)
