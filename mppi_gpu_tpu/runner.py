"""Closed-loop drivers: controller vs ground-truth world.

Two modes, mirroring and extending the reference's single host loop
(reference src/main.cu:326-374):

  * :func:`run_closed_loop` — interactive host loop: measure state → solve →
    apply first action to the world → repeat until the episode ends. Works
    against either world backend (native C++ or JAX) and records per-solve
    wall-clock exactly like the reference's "Average controller execution
    time" metric. Optional per-step debug dumps (reference save_step path).

  * :func:`run_episode_jit` — a mode the reference cannot do:
    the ENTIRE episode (≈600 control cycles of solve + world physics) is one
    `lax.scan` under jit — zero host↔device round-trips.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mppi_gpu_tpu.controller import MPPIController
from mppi_gpu_tpu.envs import (
    is_cartpole_env,
    is_quadrotor_env,
    is_quadrotor3d_env,
    is_pendulum_env,
    make_jax_world,
    params_for_config,
)
from mppi_gpu_tpu.envs.params import WorldParams
from mppi_gpu_tpu.envs.point_mass_world import PointMassWorld
from mppi_gpu_tpu.io.csvio import write_step_dump_csv, write_traj_csv
from mppi_gpu_tpu.utils.timing import SolveTimer


@dataclass
class EpisodeResult:
    times: np.ndarray        # (N,) sim time at each control step
    xs: np.ndarray           # (N+1, s) world states (x_0 .. x_N)
    us: np.ndarray           # (N, a) executed actions
    solve_ms: dict[str, float] = field(default_factory=dict)

    @property
    def final_state(self) -> np.ndarray:
        return self.xs[-1]


def _make_world(cfg, params, backend: str) -> Any:
    if backend in ("native", "mujoco"):
        from mppi_gpu_tpu.envs import is_arm_env, is_unicycle_env

        if is_unicycle_env(cfg.env):
            raise ValueError(
                "the unicycle family is kinematic — there is no native/MuJoCo "
                "plant to adjudicate (no contact or inertia physics); its "
                "fine-RK4 JAX world IS the ground truth (use --world jax)"
            )
        if is_arm_env(cfg.env) and backend == "native":
            raise ValueError(
                "no native C++ twin is wired for the arm family; use "
                "--world jax or --world mujoco"
            )
    if backend == "native":
        if is_quadrotor3d_env(cfg.env):
            from mppi_gpu_tpu.envs.native import NativeQuadrotor3DWorld

            return NativeQuadrotor3DWorld(params)
        if is_quadrotor_env(cfg.env):
            from mppi_gpu_tpu.envs.native import NativeQuadrotorWorld

            return NativeQuadrotorWorld(params)
        if is_cartpole_env(cfg.env):
            from mppi_gpu_tpu.envs.native import NativeCartPoleWorld

            return NativeCartPoleWorld(params)
        if is_pendulum_env(cfg.env):
            from mppi_gpu_tpu.envs.native import NativePendulumWorld

            return NativePendulumWorld(params)
        from mppi_gpu_tpu.envs.native import NativePointMassWorld

        return NativePointMassWorld(params)
    if backend == "jax":
        return _JaxWorldAdapter(make_jax_world(cfg, params))
    if backend == "mujoco":
        # the real MuJoCo engine as the plant (optional dependency) — the
        # reference's actual ground truth for the point-mass family
        # (PointMassEnv.cpp:53-61), extended to every env family here
        if is_quadrotor3d_env(cfg.env):
            from mppi_gpu_tpu.envs.mujoco_world import MujocoQuadrotor3DWorld

            return MujocoQuadrotor3DWorld(params)
        if is_quadrotor_env(cfg.env):
            from mppi_gpu_tpu.envs.mujoco_world import MujocoQuadrotorWorld

            return MujocoQuadrotorWorld(params)
        if is_cartpole_env(cfg.env):
            from mppi_gpu_tpu.envs.mujoco_world import MujocoCartPoleWorld

            return MujocoCartPoleWorld(params)
        if is_pendulum_env(cfg.env):
            from mppi_gpu_tpu.envs.mujoco_world import MujocoPendulumWorld

            return MujocoPendulumWorld(params)
        from mppi_gpu_tpu.envs import is_arm_env as _is_arm

        if _is_arm(cfg.env):
            from mppi_gpu_tpu.envs.mujoco_world import MujocoArmWorld

            return MujocoArmWorld(params)
        from mppi_gpu_tpu.envs.mujoco_world import MujocoPointMassWorld

        xml = str(cfg.env) if str(cfg.env).endswith(".xml") else None
        return MujocoPointMassWorld(params, xml_path=xml)
    raise ValueError(f"unknown world backend '{backend}' (native|jax|mujoco)")


class _JaxWorldAdapter:
    """Host-loop adapter giving the JAX world the reference-env API
    (`simulate(u) -> done`, `get_x()`), with jitted step."""

    def __init__(self, world: PointMassWorld) -> None:
        self.world = world
        self.params = world.params
        self.state = world.reset()
        self._simulate = jax.jit(world.simulate)

    def reset(self) -> None:
        self.state = self.world.reset()

    def simulate(self, u: np.ndarray) -> bool:
        self.state, done = self._simulate(self.state, jnp.asarray(u, jnp.float32))
        return bool(done)

    def get_x(self) -> np.ndarray:
        return np.asarray(self.state.x)

    @property
    def time(self) -> float:
        return float(self.state.time)

    def set_state(self, x: np.ndarray, time: float) -> None:
        """Restore from a checkpoint: x = state vector, sim time."""
        self.state = self.world.from_x(jnp.asarray(x, jnp.float32), time)


def _launch_viewer(world) -> Any:
    """Open the live interactive viewer over the real MuJoCo plant — the
    analog of the reference's GLFW window + mjv/mjr scene and camera
    (reference src/PointMassEnv.cpp:65-92, 141-169, 200-264; here MuJoCo's
    own `mujoco.viewer` supplies the window, render loop and mouse/keyboard
    camera). Needs the mujoco world backend and a display; raises
    ConfigError with a actionable message otherwise. Module-level so tests
    can substitute a stub handle."""
    from mppi_gpu_tpu.config import ConfigError

    if not (hasattr(world, "m") and hasattr(world, "d")):
        raise ConfigError(
            "--view drives the live MuJoCo viewer and needs the real engine "
            "as the plant: add --world mujoco"
        )
    import sys as _sys

    if _sys.platform.startswith("linux") and not (
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
    ):
        # pre-check (Linux only — macOS GUI sessions set neither variable):
        # glfwInit on a headless host ABORTS the process rather than
        # raising, so never reach it without a display
        raise ConfigError(
            "--view needs a display (no DISPLAY/WAYLAND_DISPLAY set). "
            "For headless replay, record with -t and use scripts/animate.py"
        )
    try:
        import mujoco.viewer as _mj_viewer

        return _mj_viewer.launch_passive(world.m, world.d)
    except Exception as e:  # noqa: BLE001 — GLFW/EGL init failures
        raise ConfigError(
            f"could not open the live viewer (needs a working GL display): "
            f"{e}. For headless replay, record with -t and use "
            "scripts/animate.py"
        ) from e


def run_closed_loop(
    ctrl: MPPIController,
    *,
    world_backend: str = "jax",
    world_params: WorldParams | None = None,
    max_steps: int | None = None,
    traj_csv: str | os.PathLike | None = None,
    step_dump_every: int | None = None,
    step_dump_dir: str | os.PathLike | None = None,
    verbose: bool = False,
    checkpoint_path: str | os.PathLike | None = None,
    checkpoint_every: int | None = None,
    resume_from: str | os.PathLike | None = None,
    validate: bool = True,
    view: bool = False,
) -> EpisodeResult:
    """Interactive closed loop (the reference's main loop, src/main.cu:326-374).

    Checkpoint/resume (no reference analog): with `checkpoint_path` +
    `checkpoint_every`, the loop state (step, U, base key, world state) is
    snapshotted atomically every N steps; `resume_from` restores it and the
    run continues bit-identically to an uninterrupted one (the per-step key
    is derived by folding the absolute step index into the base key). On
    resume, the returned EpisodeResult covers only the resumed suffix."""
    params = world_params or params_for_config(ctrl.cfg)
    world = _make_world(ctrl.cfg, params, world_backend)
    viewer = _launch_viewer(world) if view else None

    U = ctrl.init_action_seq()
    key = ctrl.init_key()
    timer = SolveTimer()
    step = 0

    if resume_from is not None:
        from mppi_gpu_tpu.io.checkpoint import load_checkpoint

        ck = load_checkpoint(resume_from)
        U = jnp.asarray(ck.U)
        key = ck.key()
        step = ck.step
        world.set_state(ck.x, ck.time)

    xs = [world.get_x()]
    us: list[np.ndarray] = []
    times: list[float] = []

    import contextlib

    with contextlib.ExitStack() as _stack:
        if viewer is not None:
            _stack.callback(viewer.close)
        _last_wall: float | None = None
        limit = max_steps if max_steps is not None else params.num_control_steps() + 5
        while step < limit:
            if (
                checkpoint_path is not None
                and checkpoint_every
                and step % checkpoint_every == 0
            ):
                from mppi_gpu_tpu.io.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_path, step=step, U=U, key=key,
                    x=xs[-1], time=world.time, cfg=ctrl.cfg,
                )
            x = jnp.asarray(xs[-1])
            U_prev = U
            is_dump = bool(step_dump_every and step % step_dump_every == 0 and step_dump_dir)
            if is_dump:
                # Dump steps run solve_debug INSTEAD of the hot-path solve — it
                # is backend-faithful (scan reproduces the threefry stream,
                # pallas replays the kernels' counter-based stream via
                # ops.noise.noise_tensor), so the CSV documents the exact solve that drives the
                # robot — the analog of the reference's bit-faithful get_inf
                # download of the executed buffers (src/point_mass.cu:236-262,
                # src/main.cu:355-367). Excluded from the solve timer: it
                # materializes eps + the (T+1, K, s) history the hot path never
                # pays for. (Under a sharded controller the dump documents the
                # single-chip-equivalent solve instead; the sharded noise layout
                # is per-device.)
                res, eps, traj = ctrl.solve_debug(
                    x, U_prev, jax.random.fold_in(key, step)
                )
                res.action.block_until_ready()
                write_step_dump_csv(
                    os.path.join(step_dump_dir, f"step_{step:05d}.csv"),
                    np.asarray(traj), np.asarray(eps),
                    np.asarray(res.info.u_seq), np.asarray(U_prev),
                    np.asarray(res.info.weights), np.asarray(res.info.costs),
                )
            else:
                with timer.measure():
                    res = ctrl.solve_auto(x, U, key, step)
                    res.action.block_until_ready()
            action = np.asarray(res.action)
            U = res.u_next
            if validate:
                # free on the happy path: `action` is already on the host, and the
                # (K,) diagnostics are only fetched after a failure is detected.
                # Guards the result that actually advances the world, dump or not.
                from mppi_gpu_tpu.utils.guard import check_solve

                check_solve(step, action, res.info)

            done = world.simulate(action)
            if viewer is not None:
                # window closed ends the episode, like the reference's
                # glfwWindowShouldClose check (PointMassEnv.cpp:118)
                if not viewer.is_running():
                    break
                viewer.sync()
                # real-time pacing (the reference's usleep-to-frame-time loop,
                # PointMassEnv.cpp:150-161): sleep off whatever remains of the
                # control period so the window plays at sim speed
                import time as _time

                now = _time.perf_counter()
                if _last_wall is not None:
                    ahead = params.control_period - (now - _last_wall)
                    if ahead > 0:
                        _time.sleep(ahead)
                _last_wall = _time.perf_counter()
            if done:
                break
            times.append(world.time)
            xs.append(world.get_x())
            us.append(action)
            if verbose:
                # per-phase stats — the analog of the reference's _verb device
                # print kernels (src/mppi_utils.cu:7-105): β, η and the cost
                # spread for this solve, alongside state/action
                beta = float(np.asarray(res.info.beta))
                eta = float(np.asarray(res.info.eta))
                print(
                    f"[{step:4d}] t={times[-1]:7.3f}  x={xs[-1]}  u={action}  "
                    f"beta={beta:.4g} eta={eta:.4g}"
                )
            step += 1

    result = EpisodeResult(
        times=np.asarray(times),
        xs=np.asarray(xs),
        us=np.asarray(us) if us else np.zeros((0, ctrl.cfg.action_dim)),
        solve_ms=timer.summary(split_first=True),
    )
    if traj_csv is not None:
        write_traj_csv(traj_csv, result.times, result.xs[1:], result.us)
    return result


def _episode_cache(ctrl, kind: str, cache_key):
    """Per-controller cache of jitted episode programs. Rebuilding the
    `@jax.jit` closure every call would re-trace (and re-compile)
    each time — repeated calls must be actually warm, both for users and
    for the bench's warm-rep timing."""
    cache = ctrl.__dict__.setdefault("_episode_jit_cache", {})
    return cache, (kind, cache_key)


def run_episode_jit(
    ctrl: MPPIController,
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    base_key: jax.Array | None = None,
    x0: jax.Array | None = None,
) -> EpisodeResult:
    """Whole-episode jit: `lax.scan` over control cycles; each cycle is one
    MPPI solve + `steps_per_control` physics steps, all on-device.
    `base_key`/`x0` override the episode's PRNG key and start state (both
    are traced arguments, so overriding them does not re-trace)."""
    params = world_params or params_for_config(ctrl.cfg)
    world = make_jax_world(ctrl.cfg, params)
    n = num_steps if num_steps is not None else params.num_control_steps()
    key = ctrl.init_key() if base_key is None else base_key
    ws0 = world.reset() if x0 is None else world.from_x(
        jnp.asarray(x0, jnp.float32), world.reset().time
    )

    cache, ck = _episode_cache(ctrl, "single", (n, repr(params)))
    episode = cache.get(ck)
    if episode is None:

        def cycle(carry, step):
            ws, U, key = carry
            res = ctrl._solve(  # reuse the controller's jitted solve body
                ctrl.dynamics, ctrl.cost, ws.x, U,
                jax.random.fold_in(key, step),
                ctrl.sigma, ctrl.lambda_, ctrl.max_a,
            )
            ws_new, _ = world.simulate(ws, res.action)
            return (ws_new, res.u_next, key), (ws_new.x, res.action, ws_new.time)

        @jax.jit
        def episode(U0, ws0, key):
            (_, _, _), (xs, us, ts) = jax.lax.scan(
                cycle, (ws0, U0, key), jnp.arange(n)
            )
            return xs, us, ts

        cache[ck] = episode

    xs, us, ts = episode(ctrl.init_action_seq(), ws0, key)
    x0_row = np.asarray(ws0.x)[None]
    return EpisodeResult(
        times=np.asarray(ts),
        xs=np.concatenate([x0_row, np.asarray(xs)], axis=0),
        us=np.asarray(us),
    )


def run_fleet_episode_jit(
    ctrl,  # BatchedMPPIController
    *,
    world_params: WorldParams | None = None,
    num_steps: int | None = None,
    xs0: jax.Array | None = None,  # (R, s) per-robot initial states
) -> EpisodeResult:
    """Whole-FLEET episode jit: R independent closed loops — R solves + R
    world steps per control cycle — as ONE `lax.scan` under jit. Composes
    the two device-resident modes (whole-episode jit × fleet solve): with
    the fused fleet kernels inside the scan, an entire multi-robot episode runs
    on-device with zero host round-trips. No reference analog (the
    reference is one robot, one GPU, host-driven).

    Returns an EpisodeResult whose xs/us carry a robot axis:
    xs (N+1, R, s), us (N, R, a); times is the shared sim clock."""
    params = world_params or params_for_config(ctrl.cfg)
    world = make_jax_world(ctrl.cfg, params)
    n = num_steps if num_steps is not None else params.num_control_steps()
    R = ctrl.n_robots
    keys0 = ctrl.init_keys()

    ws_single = world.reset()
    ws0 = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (R,) + jnp.shape(leaf)), ws_single
    )
    if xs0 is not None:
        xs0 = jnp.asarray(xs0, jnp.float32)
        if xs0.shape != (R, ctrl.cfg.state_dim):
            raise ValueError(
                f"xs0 must be ({R}, {ctrl.cfg.state_dim}), got {xs0.shape}"
            )
        t0 = ws_single.time
        states = [world.from_x(xs0[r], t0) for r in range(R)]
        ws0 = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *states)

    # WorldState.x is a property written for a SINGLE state (it concatenates
    # leaves along axis 0), so extract the batched state vector under vmap
    x_of = jax.vmap(lambda ws: ws.x)

    cache, ck = _episode_cache(ctrl, "fleet", (n, R, repr(params)))
    episode = cache.get(ck)
    if episode is None:
        sim_batch = jax.vmap(world.simulate)

        def cycle(carry, step):
            ws, Us, keys0 = carry
            keys = jax.vmap(jax.random.fold_in, (0, None))(keys0, step)
            res = ctrl._solve_batch(  # scan-vmap or the fleet fused kernel
                ctrl.dynamics, ctrl.cost, x_of(ws), Us, keys,
                ctrl.sigma, ctrl.lambda_, ctrl.max_a,
            )
            ws_new, _ = sim_batch(ws, res.action)
            return (ws_new, res.u_next, keys0), (
                x_of(ws_new), res.action, ws_new.time[0]
            )

        @jax.jit
        def episode(Us0, ws0, keys0):
            (_, _, _), (xs, us, ts) = jax.lax.scan(
                cycle, (ws0, Us0, keys0), jnp.arange(n)
            )
            return xs, us, ts

        cache[ck] = episode

    xs, us, ts = episode(ctrl.init_action_seqs(), ws0, keys0)
    x0 = np.asarray(x_of(ws0))[None]
    return EpisodeResult(
        times=np.asarray(ts),
        xs=np.concatenate([x0, np.asarray(xs)], axis=0),
        us=np.asarray(us),
    )
