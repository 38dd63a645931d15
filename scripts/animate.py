#!/usr/bin/env python
"""Render a closed-loop trajectory CSV as an animation — the offline analog
of the reference's live GLFW/OpenGL viewer (reference PointMassEnv.cpp:141-169
renders MuJoCo scenes at 60 fps with an interactive camera; headless
accelerator machines have no display, so this replays the recorded episode as a GIF instead).

    python scripts/animate.py traj.csv -c configs/point_mass2d.yaml -o out.gif

Scene layout per env family (from the config's `env` key):

* ``point_mass{1,2,3}d`` — the mass as a dot in the arena, trail behind it,
  goal as a star, executed action as an arrow, config obstacles as circles.
  3-D uses a matplotlib 3-D projection.
* ``pendulum`` — rod from the pivot; θ=0 is upright (the swing-up target).
* ``cartpole`` — cart rectangle on a rail + pole; θ=0 is upright.
* ``quadrotor`` — planar birotor body segment + trail + goal star; the
  body tilts with θ (positive = right tip down).

The CSV is the one `mppi_gpu_tpu.cli -t` / `write_traj_csv` produces
(columns time, x[i], u[i] — reference to_csv_traj, src/main.cu:32-57).
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.animation as manim
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mppi_gpu_tpu.io.csvio import read_csv_columns


def _load(path):
    cols = read_csv_columns(path)
    s = sum(1 for k in cols if k.startswith("x["))
    a = sum(1 for k in cols if k.startswith("u["))
    t = cols["time"]
    xs = np.stack([cols[f"x[{i}]"] for i in range(s)], axis=1)
    us = np.stack([cols[f"u[{i}]"] for i in range(a)], axis=1)
    return t, xs, us


def _pad_limits(lo: float, hi: float, frac: float = 0.15) -> tuple[float, float]:
    span = max(hi - lo, 0.5)
    return lo - frac * span, hi + frac * span


class _PointMassScene:
    """1/2/3-D point mass: dot + trail + goal star + action arrow +
    obstacle circles (2-D/3-D obstacles drawn in the first two coords)."""

    def __init__(self, ax, xs, us, goal, obstacles, dim):
        self.dim = dim
        self.xs, self.us = xs, us
        if dim == 1:
            # embed on a horizontal line: (q, 0)
            self.pos = np.stack([xs[:, 0], np.zeros(len(xs))], axis=1)
            g = None if goal is None else np.array([goal[0], 0.0])
        else:
            self.pos = xs[:, :2] if dim == 2 else xs[:, :3]
            g = None if goal is None else np.asarray(goal[:dim], float)
        p = self.pos
        if dim == 3:
            ax.set(xlabel="q0", ylabel="q1", zlabel="q2")
            for axis, set_lim in zip(range(3), (ax.set_xlim, ax.set_ylim, ax.set_zlim)):
                vals = [p[:, axis].min(), p[:, axis].max()]
                if g is not None:
                    vals += [g[axis]]
                set_lim(*_pad_limits(min(vals), max(vals)))
            uu, vv = np.meshgrid(
                np.linspace(0.0, 2.0 * np.pi, 24), np.linspace(0.0, np.pi, 12)
            )
            for ob in obstacles:
                c, r = np.asarray(ob[:3], float), float(ob[-1])
                ax.plot_surface(
                    c[0] + r * np.cos(uu) * np.sin(vv),
                    c[1] + r * np.sin(uu) * np.sin(vv),
                    c[2] + r * np.cos(vv),
                    color="crimson", alpha=0.2, linewidth=0, zorder=1,
                )
        else:
            vals0 = [p[:, 0].min(), p[:, 0].max()] + ([g[0]] if g is not None else [])
            vals1 = [p[:, 1].min(), p[:, 1].max()] + ([g[1]] if g is not None else [])
            ax.set_xlim(*_pad_limits(min(vals0), max(vals0)))
            ax.set_ylim(*_pad_limits(min(vals1), max(vals1)))
            ax.set_aspect("equal", adjustable="box")
            ax.set(xlabel="q0", ylabel="q1" if dim == 2 else "")
            for ob in obstacles:
                ax.add_patch(
                    plt.Circle(tuple(ob[:2]) if dim >= 2 else (ob[0], 0.0), ob[-1],
                               color="crimson", alpha=0.25, zorder=1)
                )
        if g is not None:
            star = dict(marker="*", color="goldenrod", markersize=16, zorder=3)
            ax.plot(*g, linestyle="", **star)
        (self.trail,) = ax.plot([], [], *([[]] if dim == 3 else []),
                                lw=1.0, color="steelblue", alpha=0.7, zorder=2)
        (self.dot,) = ax.plot([], [], *([[]] if dim == 3 else []),
                              marker="o", color="navy", markersize=9, zorder=4)
        self.arrow = None
        self.ax = ax

    def update(self, i):
        p = self.pos
        if self.dim == 3:
            self.trail.set_data_3d(p[: i + 1, 0], p[: i + 1, 1], p[: i + 1, 2])
            self.dot.set_data_3d([p[i, 0]], [p[i, 1]], [p[i, 2]])
        else:
            self.trail.set_data(p[: i + 1, 0], p[: i + 1, 1])
            self.dot.set_data([p[i, 0]], [p[i, 1]])
            if self.arrow is not None:
                self.arrow.remove()
                self.arrow = None
            if i < len(self.us):
                u = self.us[i]
                du = (u[0], 0.0) if self.dim == 1 else (u[0], u[1])
                self.arrow = self.ax.annotate(
                    "", xytext=p[i, :2] if self.dim >= 2 else (p[i, 0], 0.0),
                    xy=(p[i, 0] + 0.25 * du[0],
                        (p[i, 1] if self.dim >= 2 else 0.0) + 0.25 * du[1]),
                    arrowprops=dict(arrowstyle="->", color="darkorange", lw=1.6),
                )
        return [self.trail, self.dot]


class _UnicycleScene(_PointMassScene):
    """Differential-drive robot: the planar path scene plus a heading
    segment from the pose angle (state [px, py, θ]; the action [v, ω] is
    not a position-space vector, so the generic action arrow is off)."""

    def __init__(self, ax, xs, us, goal):
        super().__init__(ax, xs, np.zeros((0, 2)), goal, (), 2)
        self.th = xs[:, 2]
        (self.head,) = ax.plot([], [], color="darkorange", lw=2.5, zorder=6)

    def update(self, i):
        art = super().update(i)
        L = 0.15
        x, y, th = self.pos[i, 0], self.pos[i, 1], self.th[i]
        self.head.set_data([x, x + L * np.cos(th)], [y, y + L * np.sin(th)])
        return art + [self.head]


class _PendulumScene:
    """Rod from the pivot; state x = (θ, θ̇) with θ=0 upright."""

    def __init__(self, ax, xs, us, length=1.0):
        self.th = xs[:, 0]
        self.l = length
        lim = 1.3 * length
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_aspect("equal")
        ax.plot(0, 0, marker="o", color="0.3", markersize=5)
        ax.plot(0, length, marker="*", color="goldenrod", markersize=14)
        (self.rod,) = ax.plot([], [], lw=3, color="navy", solid_capstyle="round")
        (self.bob,) = ax.plot([], [], marker="o", color="steelblue", markersize=12)

    def update(self, i):
        # θ measured from upright: tip = (l sinθ, l cosθ)
        x, y = self.l * np.sin(self.th[i]), self.l * np.cos(self.th[i])
        self.rod.set_data([0, x], [0, y])
        self.bob.set_data([x], [y])
        return [self.rod, self.bob]


class _ArmScene:
    """Two-link arm from the shoulder; state x = (q1, q2, q̇1, q̇2) with q1
    from the +x axis and q2 relative (models/arm.py). Draws both links via
    the same forward kinematics the reach cost uses, plus the target."""

    def __init__(self, ax, xs, us, goal=None, l1=0.5, l2=0.5):
        self.q1, self.q2 = xs[:, 0], xs[:, 1]
        self.l1, self.l2 = l1, l2
        lim = 1.15 * (l1 + l2)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_aspect("equal")
        ax.plot(0, 0, marker="o", color="0.3", markersize=6)
        if goal is not None:
            ax.plot(goal[0], goal[1], marker="*", color="goldenrod",
                    markersize=14)
        (self.links,) = ax.plot([], [], lw=3, color="navy",
                                solid_capstyle="round", marker="o",
                                markersize=6, markerfacecolor="steelblue")
        (self.trail,) = ax.plot([], [], lw=1, color="0.7", alpha=0.7)
        self._ee = np.stack(
            [l1 * np.cos(self.q1) + l2 * np.cos(self.q1 + self.q2),
             l1 * np.sin(self.q1) + l2 * np.sin(self.q1 + self.q2)], axis=1)

    def update(self, i):
        q1, q12 = self.q1[i], self.q1[i] + self.q2[i]
        ex1, ey1 = self.l1 * np.cos(q1), self.l1 * np.sin(q1)
        self.links.set_data(
            [0, ex1, ex1 + self.l2 * np.cos(q12)],
            [0, ey1, ey1 + self.l2 * np.sin(q12)],
        )
        self.trail.set_data(self._ee[: i + 1, 0], self._ee[: i + 1, 1])
        return [self.links, self.trail]


class _CartPoleScene:
    """Cart on a rail + pole; state x = (p, θ, ṗ, θ̇), θ=0 upright."""

    def __init__(self, ax, xs, us, pole_len=1.0):
        self.p, self.th = xs[:, 0], xs[:, 1]
        self.l = pole_len
        lo, hi = _pad_limits(self.p.min() - 0.5, self.p.max() + 0.5)
        ax.set_xlim(lo, hi)
        ax.set_ylim(-0.6, 1.6 * pole_len + 0.4)
        ax.set_aspect("equal", adjustable="box")
        ax.axhline(0, color="0.6", lw=1)
        self.cart = plt.Rectangle((0, -0.1), 0.4, 0.2, color="0.3", zorder=3)
        ax.add_patch(self.cart)
        (self.pole,) = ax.plot([], [], lw=3, color="navy",
                               solid_capstyle="round", zorder=4)

    def update(self, i):
        p, th = self.p[i], self.th[i]
        self.cart.set_xy((p - 0.2, -0.1))
        # full pole length = 2l (pole_length is the half-length)
        tip = (p + 2 * self.l * np.sin(th), 2 * self.l * np.cos(th))
        self.pole.set_data([p, tip[0]], [0, tip[1]])
        return [self.pole]


class _QuadrotorScene:
    """Planar birotor: body segment tilted by θ, rotor dots, trail, goal
    star; state x = (px, pz, θ, vx, vz, ω)."""

    def __init__(self, ax, xs, us, goal=None, arm=0.17):
        self.p = xs[:, :2]
        self.th = xs[:, 2]
        self.arm = arm
        g = None if goal is None else np.asarray(goal[:2], float)
        vals0 = [self.p[:, 0].min(), self.p[:, 0].max()] + ([g[0]] if g is not None else [])
        vals1 = [self.p[:, 1].min(), self.p[:, 1].max()] + ([g[1]] if g is not None else [])
        ax.set_xlim(*_pad_limits(min(vals0) - 2 * arm, max(vals0) + 2 * arm))
        ax.set_ylim(*_pad_limits(min(vals1) - 2 * arm, max(vals1) + 2 * arm))
        ax.set_aspect("equal", adjustable="box")
        ax.set(xlabel="x", ylabel="z")
        if g is not None:
            ax.plot(*g, linestyle="", marker="*", color="goldenrod",
                    markersize=16, zorder=3)
        (self.trail,) = ax.plot([], [], lw=1.0, color="steelblue",
                                alpha=0.7, zorder=2)
        (self.body,) = ax.plot([], [], lw=4, color="navy",
                               solid_capstyle="round", zorder=4)
        (self.rotors,) = ax.plot([], [], linestyle="", marker="o",
                                 color="darkorange", markersize=6, zorder=5)

    def update(self, i):
        px, pz = self.p[i]
        c, s = np.cos(self.th[i]), np.sin(self.th[i])
        # body x-axis in world coords: rotation about +y maps x̂ → (cosθ, −sinθ)
        # in the x–z plane (positive θ = right tip down)
        dx, dz = self.arm * c, -self.arm * s
        self.body.set_data([px - dx, px + dx], [pz - dz, pz + dz])
        self.rotors.set_data([px - dx, px + dx], [pz - dz, pz + dz])
        self.trail.set_data(self.p[: i + 1, 0], self.p[: i + 1, 1])
        return [self.trail, self.body, self.rotors]


class _Quadrotor3DScene:
    """Full 3-D quadrotor: crossed body arms oriented by the quaternion,
    trail, goal star; state x = (p(3), quat(4), v(3), ω(3))."""

    def __init__(self, ax, xs, us, goal=None, arm=0.17):
        self.p = xs[:, 0:3]
        self.q = xs[:, 3:7]
        self.arm = arm
        g = None if goal is None else np.asarray(goal[:3], float)
        for axis, set_lim in zip(range(3), (ax.set_xlim, ax.set_ylim, ax.set_zlim)):
            vals = [self.p[:, axis].min(), self.p[:, axis].max()]
            if g is not None:
                vals.append(g[axis])
            set_lim(*_pad_limits(min(vals) - arm, max(vals) + arm))
        ax.set(xlabel="x", ylabel="y", zlabel="z")
        if g is not None:
            ax.plot([g[0]], [g[1]], [g[2]], linestyle="", marker="*",
                    color="goldenrod", markersize=16, zorder=3)
        (self.trail,) = ax.plot([], [], [], lw=1.0, color="steelblue",
                                alpha=0.7, zorder=2)
        (self.arm_x,) = ax.plot([], [], [], lw=3.5, color="navy",
                                solid_capstyle="round", zorder=4)
        (self.arm_y,) = ax.plot([], [], [], lw=3.5, color="royalblue",
                                solid_capstyle="round", zorder=4)

    def update(self, i):
        from mppi_gpu_tpu.envs.quadrotor3d_world import quat_to_body_axes

        p = self.p[i]
        bx, by = quat_to_body_axes(self.q[i], self.arm)
        self.arm_x.set_data_3d(*[[p[d] - bx[d], p[d] + bx[d]] for d in range(3)])
        self.arm_y.set_data_3d(*[[p[d] - by[d], p[d] + by[d]] for d in range(3)])
        self.trail.set_data_3d(self.p[: i + 1, 0], self.p[: i + 1, 1],
                               self.p[: i + 1, 2])
        return [self.trail, self.arm_x, self.arm_y]


def make_animation(t, xs, us, cfg=None, env: str | None = None,
                   stride: int = 1, fps: int = 30):
    """Build (fig, FuncAnimation) for the episode. `cfg` (MPPIConfig) supplies
    env name, goal, and obstacles when given; `env` overrides the family."""
    env = env or (cfg.env if cfg is not None else "point_mass2d")
    goal = None if cfg is None else np.asarray(cfg.goal, float)
    obstacles = () if cfg is None else cfg.obstacles

    is3d = env.startswith("point_mass3") or env.startswith("quadrotor3d")
    fig = plt.figure(figsize=(6.4, 6.4))
    ax = fig.add_subplot(111, projection="3d" if is3d else None)

    if env.startswith("pendulum"):
        scene = _PendulumScene(ax, xs, us)
    elif env.startswith("unicycle"):
        scene = _UnicycleScene(ax, xs, us, goal)
    elif env.startswith("arm"):
        scene = _ArmScene(ax, xs, us, goal)
    elif env.startswith("cartpole"):
        scene = _CartPoleScene(ax, xs, us)
    elif env.startswith("quadrotor3d"):
        scene = _Quadrotor3DScene(ax, xs, us, goal)
    elif env.startswith("quadrotor"):
        scene = _QuadrotorScene(ax, xs, us, goal)
    else:
        dim = 3 if is3d else (1 if env.startswith("point_mass1") else 2)
        scene = _PointMassScene(ax, xs, us, goal, obstacles, dim)

    frames = range(0, len(xs), max(1, stride))
    title = ax.set_title("")

    def step(i):
        title.set_text(f"{env}   t = {t[min(i, len(t) - 1)]:6.3f} s")
        return scene.update(i) + [title]

    anim = manim.FuncAnimation(fig, step, frames=frames,
                               interval=1000.0 / fps, blit=False)
    return fig, anim


def _mujoco_render_model(env: str, cfg):
    """Build the MuJoCo model + camera for replay rendering: the family's
    physics MJCF (the same generators the `--world mujoco` backend steps)
    with visual-only extras injected — floor plane, light, goal/obstacle
    markers. Nothing is stepped; frames come from FK (`mj_forward`) on the
    recorded states, so the extras cannot perturb the replay."""
    import mujoco

    from mppi_gpu_tpu.envs import (
        is_arm_env,
        is_cartpole_env,
        is_pendulum_env,
        is_quadrotor3d_env,
        is_quadrotor_env,
        params_for_config,
    )
    from mppi_gpu_tpu.envs.mujoco_world import (
        _cartpole_mjcf,
        _pendulum_mjcf,
        _point_mass_mjcf,
        _quadrotor3d_mjcf,
        _quadrotor_mjcf,
    )

    params = params_for_config(cfg) if cfg is not None else None
    extras = [
        '<light directional="true" pos="0 -1 3" dir="0 0.25 -1" '
        'diffuse="0.45 0.45 0.45" specular="0 0 0"/>',
    ]
    cam = mujoco.MjvCamera()
    mujoco.mjv_defaultCamera(cam)
    if is_pendulum_env(env):
        xml = _pendulum_mjcf(params)
        cam.lookat[:] = (0.0, 0.0, 0.3)
        cam.distance, cam.elevation, cam.azimuth = 3.5, -10.0, 90.0
        extras.append(  # swing-up target: the upright tip position
            f'<site name="target" pos="0 0 {params.length}" size="0.05" '
            'rgba="1 0.8 0.1 0.6"/>'
        )
    elif is_quadrotor3d_env(env):
        xml = _quadrotor3d_mjcf(params)
        cam.lookat[:] = (0.0, 0.25, 0.75)
        cam.distance, cam.elevation, cam.azimuth = 4.5, -15.0, 120.0
        if cfg is not None and cfg.goal is not None:
            g = np.asarray(cfg.goal, float)
            extras.append(
                f'<site name="target" pos="{g[0]} {g[1]} {g[2]}" size="0.06" '
                'rgba="1 0.8 0.1 0.7"/>'
            )
    elif is_quadrotor_env(env):
        xml = _quadrotor_mjcf(params)
        cam.lookat[:] = (0.0, 0.0, 0.3)
        cam.distance, cam.elevation, cam.azimuth = 4.5, -10.0, 90.0
        if cfg is not None and cfg.goal is not None:
            g = np.asarray(cfg.goal, float)
            extras.append(
                f'<site name="target" pos="{g[0]} 0 {g[1]}" size="0.06" '
                'rgba="1 0.8 0.1 0.7"/>'
            )
    elif is_cartpole_env(env):
        xml = _cartpole_mjcf(params)
        cam.lookat[:] = (0.0, 0.0, 0.4)
        cam.distance, cam.elevation, cam.azimuth = 4.5, -10.0, 90.0
        extras.append(
            '<geom type="cylinder" fromto="-2.6 0 0 2.6 0 0" size="0.01" '
            'rgba="0.5 0.5 0.5 0.5" contype="0" conaffinity="0" mass="0"/>'
        )
    elif is_arm_env(env):
        from mppi_gpu_tpu.envs.mujoco_world import _arm_mjcf

        xml = _arm_mjcf(params)
        cam.lookat[:] = (0.0, 0.0, 0.0)
        cam.distance, cam.elevation, cam.azimuth = 3.0, -10.0, 90.0
        if cfg is not None and cfg.goal is not None:
            g = np.asarray(cfg.goal, float)
            # analytic (x, y) plane maps to MuJoCo (x, z)
            extras.append(
                f'<site name="target" pos="{g[0]} 0 {g[1]}" size="0.04" '
                'rgba="1 0.8 0.1 0.8"/>'
            )
    else:
        from mppi_gpu_tpu.envs.params import WorldParams

        if params is None:
            params = WorldParams(n_axes=2)
        xml = _point_mass_mjcf(params)
        extras.append(
            '<geom type="plane" pos="0 0 0" size="2.5 2.5 0.1" '
            'material="grid" contype="0" conaffinity="0"/>'
        )
        if cfg is not None and cfg.goal is not None:
            g = list(np.asarray(cfg.goal, float)[: params.n_axes]) + [0.0, 0.0]
            extras.append(
                f'<site name="target" pos="{g[0]} {g[1]} {0.05 if params.n_axes < 3 else g[2]}" '
                'size="0.07" rgba="1 0.8 0.1 0.8"/>'
            )
        for j, ob in enumerate(() if cfg is None else cfg.obstacles):
            o = list(np.asarray(ob, float))
            c, r = o[:-1] + [0.0, 0.0], o[-1]
            extras.append(
                f'<geom name="obs{j}" type="sphere" pos="{c[0]} {c[1]} '
                f'{0.05 if params.n_axes < 3 else c[2]}" size="{r}" '
                'rgba="0.86 0.16 0.16 0.35" contype="0" conaffinity="0" mass="0"/>'
            )
        cam.lookat[:] = (0.0, 0.0, 0.05)
        cam.distance = 4.0
        cam.elevation, cam.azimuth = (-90.0, 90.0) if params.n_axes < 3 else (-35.0, 135.0)
    xml = xml.replace("</worldbody>", "        " + "\n        ".join(extras) + "\n    </worldbody>")
    # visual-only scene dressing: matte headlight + gradient sky
    xml = xml.replace("<worldbody>", """<visual>
        <headlight ambient="0.45 0.45 0.45" diffuse="0.55 0.55 0.55" specular="0.05 0.05 0.05"/>
    </visual>
    <asset>
        <texture type="skybox" builtin="gradient" rgb1="0.92 0.94 0.97" rgb2="0.55 0.65 0.8" width="128" height="128"/>
        <texture name="grid" type="2d" builtin="checker" rgb1="0.52 0.56 0.6" rgb2="0.38 0.43 0.49" width="256" height="256"/>
        <material name="grid" texture="grid" texrepeat="10 10" specular="0" shininess="0" reflectance="0"/>
    </asset>
    <worldbody>""")
    m = mujoco.MjModel.from_xml_string(xml)
    return m, cam


def render_mujoco_gif(t, xs, out: str, env: str, cfg=None, stride: int = 1,
                      fps: int = 30, width: int = 480, height: int = 360) -> int:
    """Replay the recorded states through the real MuJoCo renderer
    (offscreen EGL — the headless analog of the reference's
    mjv_updateScene/mjr_render loop, PointMassEnv.cpp:141-169) and save a
    GIF. Returns the frame count."""
    import mujoco
    from PIL import Image

    m, cam = _mujoco_render_model(env, cfg)
    d = mujoco.MjData(m)
    r = mujoco.Renderer(m, height, width)
    frames = []
    try:
        for i in range(0, len(xs), max(1, stride)):
            d.qpos[:] = xs[i, : m.nq]
            d.qvel[:] = xs[i, m.nq : m.nq + m.nv]
            mujoco.mj_forward(m, d)
            r.update_scene(d, camera=cam)
            frames.append(Image.fromarray(r.render()))
    finally:
        r.close()
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return len(frames)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("csv", help="trajectory CSV (time, x[i], u[i])")
    p.add_argument("-c", "--config", default=None,
                   help="YAML config (env family, goal, obstacles)")
    p.add_argument("--env", default=None,
                   help="env family override (point_mass{1,2,3}d|pendulum|cartpole|quadrotor)")
    p.add_argument("-o", "--out", default=None, help="output GIF (default: <csv>.gif)")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--stride", type=int, default=1,
                   help="render every Nth recorded step")
    p.add_argument("--renderer", choices=("matplotlib", "mujoco"),
                   default="matplotlib",
                   help="mujoco = offscreen render of the real MuJoCo scene "
                        "(needs the mujoco package + EGL/OSMesa)")
    args = p.parse_args(argv)

    t, xs, us = _load(args.csv)
    cfg = None
    if args.config:
        from mppi_gpu_tpu.config import load_config

        cfg = load_config(args.config)
    out = args.out or (os.path.splitext(args.csv)[0] + ".gif")
    if args.renderer == "mujoco":
        os.environ.setdefault("MUJOCO_GL", "egl")
        env = args.env or (cfg.env if cfg is not None else "point_mass2d")
        n_frames = render_mujoco_gif(t, xs, out, env, cfg=cfg,
                                     stride=args.stride, fps=args.fps)
    else:
        fig, anim = make_animation(t, xs, us, cfg=cfg, env=args.env,
                                   stride=args.stride, fps=args.fps)
        anim.save(out, writer=manim.PillowWriter(fps=args.fps))
        plt.close(fig)
        n_frames = len(range(0, len(xs), max(1, args.stride)))
    print(f"wrote {out} ({n_frames} frames @ {args.fps} fps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
