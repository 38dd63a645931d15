"""Fused kernels against the scan path, end to end per solve, on the GPU.

For each cell (family config, K, T, fleet size R) this times one MPPI solve
(opt-iters 1) through the `pallas` backend (ops/fused_rollout.py) and
through the `scan` backend, in turns (scan, pallas, pallas, scan), as a user
of the controller sees it: host clock around `solve` + `block_until_ready`,
the next solve chained on the previous one's `u_next`. It prints one JSON
line per cell and backend, each with the card's name and power limit.
`--blocks` adds a sweep of the kernels' largest block size; `--split`
times each kernel alone beside the plain XLA version of the same phase
(kernel A vs noise sampling + the rollout scan, kernel B vs the einsum
update over a materialized ε).

    python scripts/probe_kernels.py [--reps 30] [--out FILE] [--blocks 64,128,512] [--split]

Needs a GPU; refuses to run on anything else.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

# (name, config, K, T, R): the shipped point-mass configs as shipped, then the
# reference's benchmark scale and beyond for lti and quadrotor3d, then fleets
CELLS = [
    ("pm1d", "point_mass1d", 3000, 50, 1),
    ("pm2d", "point_mass2d", 3000, 50, 1),
    ("pm3d", "point_mass3d", 3000, 50, 1),
    ("lti", "point_mass3d", 10_000, 200, 1),
    ("lti", "point_mass3d", 100_000, 200, 1),
    ("lti", "point_mass3d", 1_000_000, 200, 1),
    ("q3d", "quadrotor3d", 10_000, 200, 1),
    ("q3d", "quadrotor3d", 100_000, 200, 1),
    ("lti-fleet", "point_mass3d", 100_000, 200, 8),
    ("q3d-fleet", "quadrotor3d", 100_000, 200, 8),
]


def _solver(cfg_path: str, K: int, T: int, R: int, backend: str):
    import jax
    import jax.numpy as jnp

    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.envs import make_jax_world

    cfg = load_config(os.path.join(ROOT, "configs", cfg_path + ".yaml")).replace(
        samples=K, horizon=T, opt_iters=1)
    x0 = make_jax_world(cfg).reset().x
    if R == 1:
        ctrl = MPPIController(cfg, rollout_backend=backend)
        state = [ctrl.init_action_seq()]
        key = ctrl.init_key()

        def solve(i):
            res = ctrl.solve_auto(x0, state[0], key, i)
            state[0] = res.u_next
            return res.action
    else:
        ctrl = BatchedMPPIController(cfg, R, rollout_backend=backend)
        xs = jnp.broadcast_to(x0, (R, cfg.state_dim))
        state = [ctrl.init_action_seqs()]
        keys = ctrl.init_keys()

        def solve(i):
            res = ctrl.solve_batch_auto(xs, state[0], keys, i)
            state[0] = res.u_next
            return res.action

    t0 = time.perf_counter()
    jax.block_until_ready(solve(0))
    return solve, time.perf_counter() - t0


def _time(solve, reps: int) -> dict:
    import jax
    import numpy as np

    ts = []
    for i in range(1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(i))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)
    return {"p50_ms": float(np.median(ts)), "p10_ms": float(np.percentile(ts, 10)),
            "p90_ms": float(np.percentile(ts, 90)), "min_ms": float(ts.min())}


SPLIT_CELLS = (("point_mass3d", 100_000, 200), ("point_mass3d", 1_000_000, 200),
               ("quadrotor3d", 100_000, 200))


def _split_cells(reps: int, cells=SPLIT_CELLS):
    """(cell, phase, backend, timing) per kernel and its plain counterpart."""
    import jax
    import jax.numpy as jnp

    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController, sample_noise_tiled
    from mppi_gpu_tpu.envs import make_jax_world
    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.rollout import rollout_costs_tiled

    for cfg_path, K, T in cells:
        cfg = load_config(os.path.join(ROOT, "configs", cfg_path + ".yaml")).replace(
            samples=K, horizon=T, opt_iters=1)
        c = MPPIController(cfg, rollout_backend="scan")
        x0, U, a = make_jax_world(cfg).reset().x, c.init_action_seq(), cfg.action_dim
        plan = fr.plan_for(c.dynamics, c.cost, K, T, a)
        rows = fr.pack_rows(c.dynamics, c.cost, x0[None], c.sigma, plan)
        w = jnp.full((1, plan.Kpad), 1.0 / K).at[:, K:].set(0.0)
        eps, _ = sample_noise_tiled(jax.random.key(0), T, K, a, c.sigma)
        wt = jnp.full(eps.shape[2:], 1.0 / K)

        def by_key(fn):
            return lambda i: fn(jax.random.fold_in(jax.random.key(1), i))

        kernel_a = jax.jit(lambda key: fr.fused_costs(
            fr.robot_words(key[None]), U[None], rows, plan))
        kernel_b = jax.jit(lambda key: fr.fused_update(
            fr.robot_words(key[None]), rows, w, plan))
        plain_a = jax.jit(lambda key: rollout_costs_tiled(
            c.dynamics, c.cost, x0, U,
            sample_noise_tiled(key, T, K, a, c.sigma)[0]))
        plain_b = jax.jit(lambda e: jnp.einsum(
            "tark,rk->ta", e, wt, precision=jax.lax.Precision.HIGHEST))
        name = f"{cfg_path} K={K} T={T}"
        for phase, backend, call in (
            ("rollout costs", "kernel A", by_key(kernel_a)),
            ("rollout costs", "XLA sample+scan", by_key(plain_a)),
            ("weighted update", "kernel B", by_key(kernel_b)),
            ("weighted update", "XLA einsum over eps", lambda i: plain_b(eps)),
        ):
            jax.block_until_ready(call(0))
            yield name, phase, backend, _time(call, reps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--out", default=None, help="also append the JSON lines here")
    p.add_argument("--cells", default=None,
                   help="comma-separated indices into CELLS (default: all)")
    p.add_argument("--blocks", default=None,
                   help="comma-separated BLOCK_MAX values to sweep (kernel only)")
    p.add_argument("--split", action="store_true",
                   help="time each kernel alone beside its plain XLA phase")
    args = p.parse_args(argv)

    from mppi_gpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from mppi_gpu_tpu.ops import fused_rollout as fr

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"device": dev.device_kind, "nvidia_smi": smi, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    cells = CELLS if args.cells is None else [
        CELLS[int(i)] for i in args.cells.split(",") if i]
    for name, cfg_path, K, T, R in cells:
        solvers = {}
        for backend in ("scan", "pallas"):
            solvers[backend], compile_s = _solver(cfg_path, K, T, R, backend)
            emit({"cell": name, "K": K, "T": T, "R": R, "backend": backend,
                  "first_call_s": compile_s})
        res = {"scan": [], "pallas": []}
        for backend in ("scan", "pallas", "pallas", "scan"):
            res[backend].append(_time(solvers[backend], args.reps))
        for backend, runs in res.items():
            emit({"cell": name, "K": K, "T": T, "R": R, "backend": backend,
                  "block": fr.pick_block(K, R) if backend == "pallas" else None,
                  "p50_ms": min(r["p50_ms"] for r in runs), "runs": runs})
        del solvers

    if args.split:
        for name, phase, backend, t in _split_cells(args.reps):
            emit({"split": name, "phase": phase, "backend": backend, **t})

    if args.blocks:
        default = fr.BLOCK_MAX
        for bmax in (int(b) for b in args.blocks.split(",")):
            fr.BLOCK_MAX = bmax
            for name, cfg_path, K, T, R in cells:
                if K < 100_000:
                    continue
                solve, _ = _solver(cfg_path, K, T, R, "pallas")
                emit({"cell": name, "K": K, "T": T, "R": R, "backend": "pallas",
                      "block": fr.pick_block(K, R), "sweep": True,
                      **_time(solve, args.reps)})
        fr.BLOCK_MAX = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
