#!/usr/bin/env python
"""Multi-robot fleet control: B independent point-mass robots, each with its
own goal, all solved in ONE jitted program per control step
(`BatchedMPPIController` — vmapped scan solve, or the fused Pallas
kernels on a GPU where the robot index is a kernel grid axis; `auto` picks
per platform/family). With B·K rollouts per step the accelerator stays
saturated even at modest per-robot K.

Run:  python examples/fleet.py [-n 8] [--steps 120]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mppi_gpu_tpu.batched import BatchedMPPIController
from mppi_gpu_tpu.config import load_config
from mppi_gpu_tpu.envs import make_jax_world


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", default="configs/point_mass2d.yaml")
    p.add_argument("-n", "--robots", type=int, default=8)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--jit", action="store_true",
                   help="run the whole fleet episode as ONE XLA program "
                   "(run_fleet_episode_jit) instead of the host loop")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    B = args.robots
    # goals on a circle of radius 0.8
    ang = np.linspace(0, 2 * np.pi, B, endpoint=False)
    goals = np.zeros((B, cfg.state_dim), np.float32)
    goals[:, 0], goals[:, 1] = 0.8 * np.cos(ang), 0.8 * np.sin(ang)

    fleet = BatchedMPPIController(cfg, B, goals=jnp.asarray(goals))
    world = make_jax_world(cfg)

    if args.jit:
        from mppi_gpu_tpu.runner import run_fleet_episode_jit

        t0 = time.perf_counter()
        res = run_fleet_episode_jit(fleet, num_steps=args.steps)
        dt = time.perf_counter() - t0
        final = np.asarray(res.xs[-1])
        dist = np.linalg.norm(final[:, :2] - goals[:, :2], axis=1)
        print(f"{B} robots x {args.steps} steps as ONE XLA program in "
              f"{dt:.1f}s (compile+run)")
        print(f"mean distance to goal: {dist.mean():.3f} m (started at 0.80)")
        return 0 if dist.mean() < 0.75 else 1

    @jax.jit
    def world_step(ws, u):
        ws2, _ = world.simulate(ws, u)
        return ws2

    states = [world.reset() for _ in range(B)]
    Us, keys = fleet.init_action_seqs(), fleet.init_keys()

    t0 = time.perf_counter()
    for step in range(args.steps):
        xs = jnp.stack([s.x for s in states])
        res = fleet.solve_batch_auto(xs, Us, keys, step)
        Us = res.u_next
        states = [world_step(s, res.action[i]) for i, s in enumerate(states)]
    dt = time.perf_counter() - t0

    final = np.stack([np.asarray(s.x) for s in states])
    dist = np.linalg.norm(final[:, :2] - goals[:, :2], axis=1)
    d0 = 0.8  # all goals start 0.8 m away
    print(f"{B} robots x {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.1f} ms/fleet-step incl. world)")
    for i in range(B):
        print(f"  robot {i}: goal ({goals[i,0]:+.2f},{goals[i,1]:+.2f})  "
              f"pos ({final[i,0]:+.3f},{final[i,1]:+.3f})  dist {dist[i]:.3f}")
    print(f"mean distance to goal: {dist.mean():.3f} m (started at {d0:.2f}; "
          f"the task needs a full ~600-step episode to converge)")
    return 0 if dist.mean() < d0 - 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
