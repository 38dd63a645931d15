"""Closed-loop CLI driver — the analog of the reference's `mppi_gpu`
executable (reference src/main.cu:220-399):

    python -m mppi_gpu_tpu.cli -c configs/point_mass2d.yaml -t traj.csv

Flags mirror the reference's TCLAP set (src/main.cu:408-439): `-c` config,
`-t` trajectory CSV, `-s` per-step dump dir (+`--dump-every`). The `-k` mjkey
flag has no analog (no licensed simulator). Extras: `--world`
backend selection, `--sharded` mesh execution, `--jit-episode` whole-episode
jit, `--rollout-backend` kernel selection, `--profile` jax.profiler traces.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mppi_gpu_tpu",
        description="MPPI closed-loop runner",
    )
    p.add_argument("-c", "--config", required=True, help="YAML config file")
    p.add_argument("-t", "--traj", default=None, help="output trajectory CSV")
    p.add_argument(
        "-s", "--step-dump-dir", default=None,
        help="directory for per-step debug dumps (reference to_csv2 analog)",
    )
    p.add_argument("--dump-every", type=int, default=50, help="dump every N steps")
    p.add_argument(
        "--world", choices=("jax", "native", "mujoco"), default="jax",
        help="ground-truth world backend (native = C++ simulator; mujoco = "
        "real mj_step, needs the optional mujoco package)",
    )
    p.add_argument(
        "--rollout-backend", choices=("auto", "scan", "pallas"), default="auto",
        help="rollout kernel: fused Pallas kernels (GPU) or XLA scan; auto "
        "picks the fused kernels on a GPU for the analytic families",
    )
    p.add_argument("--sharded", action="store_true", help="shard K over all devices")
    p.add_argument(
        "--multihost", action="store_true",
        help="multi-host bring-up: jax.distributed.initialize (auto-discovers "
        "only under a cluster manager JAX knows, e.g. SLURM; otherwise give "
        "--coordinator), then shard K over the GLOBAL mesh — run the same "
        "command in every process",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="with --multihost: explicit coordinator address "
        "(requires --num-processes and --process-id)",
    )
    p.add_argument("--num-processes", type=int, default=None, help="with --coordinator")
    p.add_argument("--process-id", type=int, default=None, help="with --coordinator")
    p.add_argument(
        "--jit-episode", action="store_true",
        help="run the whole episode as one jitted scan (JAX world only)",
    )
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", default=None, help="resume from checkpoint .npz")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument(
        "--view", action="store_true",
        help="live interactive MuJoCo viewer (needs --world mujoco and a "
        "display; the reference's GLFW window analog)",
    )
    p.add_argument("--profile", default=None, help="jax.profiler trace dir")
    p.add_argument(
        "--compile-cache", default=None, metavar="DIR", nargs="?", const="",
        help="persistent XLA compilation cache: warm restarts skip the "
        "first-solve compile. With no DIR, uses .jax_cache/ in the checkout. "
        "JAX_COMPILATION_CACHE_DIR, when set, takes precedence and also "
        "works without this flag",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    from mppi_gpu_tpu.config import ConfigError

    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(args) -> int:

    if args.compile_cache is not None:
        # before any jit: warm restarts then reuse serialized executables
        # (the reference recompiles nothing — its kernels are AOT — so this
        # restores cold-start parity for the jit world)
        from mppi_gpu_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache(args.compile_cache or None)

    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.runner import run_closed_loop, run_episode_jit
    from mppi_gpu_tpu.utils.timing import profiler_trace

    cfg = load_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)

    if args.coordinator is not None and (
        args.num_processes is None or args.process_id is None
    ):
        from mppi_gpu_tpu.config import ConfigError

        raise ConfigError(
            "--coordinator requires --num-processes and --process-id"
        )
    if args.multihost:
        # must run before the first jax.devices()/array op in this process
        from mppi_gpu_tpu.parallel import (
            ShardedMPPIController,
            global_mesh,
            init_multihost,
            is_coordinator,
        )

        pid, n_proc = init_multihost(
            args.coordinator, args.num_processes, args.process_id
        )
        mesh = global_mesh()
        print(f"multihost: process {pid}/{n_proc}, global mesh {mesh.devices.size} devices")
        ctrl: MPPIController = ShardedMPPIController(
            cfg, mesh=mesh, rollout_backend=args.rollout_backend
        )
        if not is_coordinator():
            # every host executes the same replicated loop; only the
            # coordinator owns side outputs
            args.traj = args.step_dump_dir = args.checkpoint = None
    elif args.sharded:
        from mppi_gpu_tpu.parallel import ShardedMPPIController

        ctrl = ShardedMPPIController(cfg, rollout_backend=args.rollout_backend)
    else:
        ctrl = MPPIController(cfg, rollout_backend=args.rollout_backend)

    if args.step_dump_dir:
        os.makedirs(args.step_dump_dir, exist_ok=True)

    from mppi_gpu_tpu.utils.guard import ControllerDiverged

    try:
        return _run(args, cfg, ctrl)
    except ControllerDiverged as e:
        print(f"error: {e}", file=sys.stderr)
        return 3


def _run(args, cfg, ctrl) -> int:
    from mppi_gpu_tpu.runner import run_closed_loop, run_episode_jit
    from mppi_gpu_tpu.utils.timing import profiler_trace

    if args.view and args.jit_episode:
        from mppi_gpu_tpu.config import ConfigError

        raise ConfigError(
            "--view needs the interactive host loop; drop --jit-episode"
        )
    with profiler_trace(args.profile):
        if args.jit_episode:
            result = run_episode_jit(ctrl, num_steps=args.max_steps)
        else:
            result = run_closed_loop(
                ctrl,
                world_backend=args.world,
                max_steps=args.max_steps,
                traj_csv=args.traj,
                step_dump_every=args.dump_every if args.step_dump_dir else None,
                step_dump_dir=args.step_dump_dir,
                verbose=args.verbose,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint else None,
                resume_from=args.resume,
                view=args.view,
            )

    final = result.final_state
    print(f"episode finished: {len(result.us)} control steps")
    print(f"final state: {final}")
    if result.solve_ms:
        # the reference's closing metric (src/main.cu:376-379); warm mean —
        # the first call (jit compile) is reported separately
        print(
            f"Average controller execution time: "
            f"{result.solve_ms['mean_ms']:.3f} ms"
            + (
                f" (warm; first call incl. compile: "
                f"{result.solve_ms['first_ms'] / 1e3:.1f} s)"
                if "first_ms" in result.solve_ms else ""
            )
        )
        print(json.dumps(result.solve_ms))
    if args.traj:
        print(f"trajectory written to {args.traj}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
