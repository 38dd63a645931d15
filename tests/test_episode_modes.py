"""The two closed-loop modes — interactive host loop and whole-episode jit —
must produce identical trajectories (same solves, same key folding, same
world physics), and the profiler hook must actually capture a trace."""

from __future__ import annotations

import os

import numpy as np

from mppi_gpu_tpu.config import load_config
from mppi_gpu_tpu.controller import MPPIController
from mppi_gpu_tpu.runner import run_closed_loop, run_episode_jit
from mppi_gpu_tpu.utils.timing import profiler_trace

CFG = "configs/mppi-config-test.yaml"


def test_interactive_and_jit_episode_agree():
    cfg = load_config(CFG)
    n = 12
    res_host = run_closed_loop(MPPIController(cfg), max_steps=n)
    res_jit = run_episode_jit(MPPIController(cfg), num_steps=n)
    assert len(res_host.us) == len(res_jit.us) == n
    # same solves, same keys, same noise draws — but the per-solve program
    # and the episode-scan program are separate XLA compilations, so the
    # Box-Muller trig chain may reassociate differently: f32 recompilation
    # tolerance, not bit-identity
    np.testing.assert_allclose(res_host.us, res_jit.us, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res_host.xs[-1], res_jit.xs[-1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res_host.times, res_jit.times, rtol=1e-5)


def test_episode_jit_composes_with_sharded():
    """run_episode_jit x ShardedMPPIController: the whole-episode scan with
    the sharded solve (shard_map + pmin/psum) inside each cycle, on the
    8-device virtual mesh — and it must bit-agree with the interactive host
    loop driving the SAME sharded controller."""
    from mppi_gpu_tpu.parallel import ShardedMPPIController, make_mesh

    cfg = load_config(CFG).replace(samples=64)
    n = 8
    mesh = make_mesh(8)
    res_host = run_closed_loop(ShardedMPPIController(cfg, mesh=mesh), max_steps=n)
    res_jit = run_episode_jit(ShardedMPPIController(cfg, mesh=mesh), num_steps=n)
    assert len(res_host.us) == len(res_jit.us) == n
    np.testing.assert_allclose(res_host.us, res_jit.us, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res_host.xs[-1], res_jit.xs[-1], rtol=1e-5, atol=1e-6)


def test_episode_jit_composes_with_pallas():
    """run_episode_jit x pallas backend (interpreted kernels): the fused
    solve inside the episode scan must agree with the interactive loop
    using the same backend. (chip_smoke.py runs --jit-episode on a GPU.)"""
    cfg = load_config(CFG).replace(samples=64)
    n = 4
    mk = lambda: MPPIController(  # noqa: E731
        cfg, rollout_backend="pallas-interpret"
    )
    res_host = run_closed_loop(mk(), max_steps=n)
    res_jit = run_episode_jit(mk(), num_steps=n)
    assert len(res_host.us) == len(res_jit.us) == n
    np.testing.assert_allclose(res_host.us, res_jit.us, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res_host.xs[-1], res_jit.xs[-1], rtol=1e-5, atol=1e-6)


def test_episode_jit_quadrotor3d_agrees_with_host_loop():
    """Whole-episode jit composes with the quaternion family: the 13-state
    world (quaternion renorm inside the episode scan) must bit-agree with
    the interactive host loop."""
    cfg = load_config("configs/quadrotor3d.yaml").replace(samples=128, horizon=12)
    n = 8
    res_host = run_closed_loop(MPPIController(cfg), max_steps=n)
    res_jit = run_episode_jit(MPPIController(cfg), num_steps=n)
    assert len(res_host.us) == len(res_jit.us) == n
    # not bit-identical like the LTI case: the per-solve program and the
    # episode-scan program are separate XLA compilations, and the quaternion
    # RK2 (rsqrt renorm, 13-wide stacks) gets reassociated differently —
    # observed ~5e-5 relative drift over 8 cycles, pure f32 reordering
    np.testing.assert_allclose(res_host.us, res_jit.us, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(res_host.xs[-1], res_jit.xs[-1], rtol=2e-3, atol=1e-3)


def test_profiler_trace_writes_files(tmp_path):
    cfg = load_config(CFG)
    logdir = str(tmp_path / "trace")
    with profiler_trace(logdir):
        run_closed_loop(MPPIController(cfg), max_steps=2)
    found = [
        os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs
    ]
    assert found, "profiler trace directory is empty"


def test_fleet_episode_jit_matches_per_robot_episode_jit():
    """The whole-fleet episode scan must reproduce, robot for robot, the
    single-robot episode jit driven with the same per-robot key (the fleet
    is R independent problems — no cross-robot coupling may creep in)."""
    import jax.numpy as jnp

    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.runner import run_fleet_episode_jit

    cfg = load_config(CFG)
    R = 2
    ctrl_b = BatchedMPPIController(cfg, R, rollout_backend="scan")
    xs0 = jnp.stack([jnp.zeros(cfg.state_dim), jnp.full((cfg.state_dim,), 0.1)])
    res_b = run_fleet_episode_jit(ctrl_b, num_steps=6, xs0=xs0)
    assert res_b.xs.shape == (7, R, cfg.state_dim)
    assert res_b.us.shape == (6, R, cfg.action_dim)

    keys0 = ctrl_b.init_keys()
    for r in range(R):
        # match the fleet's vmap-exact sampler (see BatchedMPPIController)
        ctrl_1 = MPPIController(cfg, rollout_backend="scan", sampler="erfinv")
        res_1 = run_episode_jit(
            ctrl_1, num_steps=6, base_key=keys0[r], x0=xs0[r]
        )
        np.testing.assert_allclose(
            res_b.xs[:, r], res_1.xs, rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            res_b.us[:, r], res_1.us, rtol=1e-5, atol=1e-6
        )


def test_fleet_episode_jit_pallas_interpret():
    """Fleet episode × fleet fused kernels: the two device-resident modes
    compose (interpreted here; chip_smoke.py runs the fleet on a GPU)."""
    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.runner import run_fleet_episode_jit

    cfg = load_config(CFG)
    ctrl = BatchedMPPIController(
        cfg, 2, rollout_backend="pallas-interpret"
    )
    res = run_fleet_episode_jit(ctrl, num_steps=4)
    assert res.xs.shape[:2] == (5, 2)
    assert np.all(np.isfinite(res.xs))
