"""Benchmark: MPPI solve latency on the reference's headline workload.

Reference baseline: ~300 ms per solve at K=10^4 rollouts x T=200 steps on the
reference's NVIDIA GPU (reference README.md:35). This script times the same
workload (point_mass3d dims) on the current JAX default device and prints ONE
JSON line naming that device:

    {"metric": "ms_per_solve_K1e4_T200", "value": <ms>, "unit": "ms",
     "vs_baseline": <300/ms speedup factor>, "device": {...}}

Extra context lines (larger K, solves/s, backend) go to stderr.

Modes:
    python bench.py                      # headline K=1e4 T=200 (auto backend)
    python bench.py --backend pallas --extra --antithetic
    python bench.py --sharded            # mesh-size sweep {1,2,..} weak+strong
    python bench.py --fleet 16           # 16-robot fleet, scan vs fused fleet
    python bench.py --fleet 8 --episode  # whole-fleet 10s episode, one program
    python bench.py --mlp                # MLP-dynamics rollout
    python bench.py --all                # the per-family table (needs a GPU)
    python bench.py --quality            # fixed-seed closed-loop quality table

A CPU harness run of the sharded sweep needs only the environment:
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BASELINE_MS = 300.0  # reference GPU, K=1e4, T=200 (README.md:35)

import jax
import jax.numpy as jnp


def make_cfg(K: int, T: int, family: str = "lti", antithetic: bool = False):
    from mppi_gpu_tpu.config import MPPIConfig

    if family == "pendulum":
        cfg = MPPIConfig(
            env="pendulum", samples=K, state_dim=2, action_dim=1, horizon=T,
            dt=0.05, lambda_=1.0, noise=(0.8,), init_act=(0.0,), max_a=(2.0,),
            goal=(0.0, 0.0), cost_type="pendulum", cost_w=(4.0, 0.2),
            antithetic=antithetic,
        )
    elif family == "cartpole":
        cfg = MPPIConfig(
            env="cartpole", samples=K, state_dim=4, action_dim=1, horizon=T,
            dt=0.03, lambda_=0.3, noise=(3.0,), init_act=(0.0,), max_a=(10.0,),
            goal=(0.0, 0.0, 0.0, 0.0), cost_type="cartpole",
            cost_w=(0.5, 20.0, 0.05, 0.1), antithetic=antithetic,
        )
    elif family == "quadrotor":
        cfg = MPPIConfig(
            env="quadrotor", samples=K, state_dim=6, action_dim=2, horizon=T,
            dt=1 / 60, lambda_=0.1, noise=(1.0, 0.15), init_act=(7.848, 0.0),
            max_a=(16.0, 3.0), goal=(1.0, 0.5, 0.0, 0.0, 0.0, 0.0),
            cost_type="quadrotor", cost_w=(4.0, 4.0, 10.0, 1.5, 1.5, 2.0),
            antithetic=antithetic,
        )
    elif family == "quadrotor3d":
        cfg = MPPIConfig(
            env="quadrotor3d", samples=K, state_dim=13, action_dim=4, horizon=T,
            dt=1 / 60, lambda_=0.3, noise=(1.2, 0.04, 0.04, 0.008),
            init_act=(7.848, 0.0, 0.0, 0.0), max_a=(32.0, 0.4, 0.4, 0.04),
            goal=(1.0, 0.5, 1.0, 1.0) + (0.0,) * 9,
            cost_type="quadrotor3d",
            cost_w=(4.0, 4.0, 4.0, 10.0, 3.0, 3.0, 3.0, 0.5),
            antithetic=antithetic,
        )
    elif family == "unicycle":
        cfg = MPPIConfig(
            env="unicycle", samples=K, state_dim=3, action_dim=2, horizon=T,
            dt=0.05, lambda_=0.3, noise=(0.6, 1.0), init_act=(0.0, 0.0),
            max_a=(1.5, 2.5), goal=(2.0, 1.0, 0.0), cost_type="unicycle",
            cost_w=(4.0, 1.0), antithetic=antithetic,
        )
    elif family == "arm":
        cfg = MPPIConfig(
            env="arm", samples=K, state_dim=4, action_dim=2, horizon=T,
            dt=1 / 60, lambda_=0.1, noise=(2.0, 1.0), noise_beta=0.8,
            init_act=(0.0, 0.0), max_a=(14.0, 7.0),
            goal=(0.55, 0.35, 0.0, 0.0), cost_type="arm", cost_w=(20.0, 0.05),
            antithetic=antithetic,
        )
    elif family == "obstacle":
        cfg = MPPIConfig(
            env="point_mass3d", samples=K, state_dim=6, action_dim=3, horizon=T,
            dt=0.1, lambda_=1.0, noise=(0.25, 0.25, 0.25),
            init_act=(0.0, 0.0, 0.0), max_a=(1.0, 1.0, 1.0),
            goal=(1.0, 0.5, 0.75, 0.0, 0.0, 0.0),
            cost_type="obstacle", cost_w=(1.0, 1.0, 1.0, 5.0, 5.0, 5.0),
            obstacles=((0.5, 0.25, 0.4, 0.2), (0.2, 0.4, 0.1, 0.15)),
            antithetic=antithetic,
        )
    else:
        cfg = MPPIConfig(
            env="point_mass3d", samples=K, state_dim=6, action_dim=3, horizon=T,
            dt=0.1, lambda_=1.0, noise=(0.25, 0.25, 0.25),
            init_act=(0.0, 0.0, 0.0), max_a=(1.0, 1.0, 1.0),
            goal=(1.0, 0.5, 0.75, 0.0, 0.0, 0.0),
            cost_type="quadratic", cost_w=(1.0, 1.0, 1.0, 5.0, 5.0, 5.0),
            antithetic=antithetic,
        )
    return cfg


def build(K: int, T: int, backend: str, antithetic: bool = False,
          mesh=None, mlp: bool = False, family: str = "lti"):
    from mppi_gpu_tpu.controller import MPPIController

    cfg = make_cfg(K, T, family, antithetic)
    dynamics = None
    if mlp:
        from mppi_gpu_tpu.models.neural import init_mlp_dynamics

        dynamics = init_mlp_dynamics(
            jax.random.key(7), cfg.state_dim, cfg.action_dim, hidden=(128, 128),
            residual_scale=0.05,
        )
        backend = "scan"  # the fused kernel covers analytic families only
    if mesh is not None:
        from mppi_gpu_tpu.parallel import ShardedMPPIController

        return ShardedMPPIController(cfg, dynamics, mesh=mesh, rollout_backend=backend)
    return MPPIController(cfg, dynamics, rollout_backend=backend)


def bench_x0(family: str) -> "jnp.ndarray":
    if family == "pendulum":
        return jnp.asarray([3.0, 0.1], jnp.float32)  # hanging, slight spin
    if family == "cartpole":
        return jnp.asarray([0.1, 0.2, 0.0, 0.0], jnp.float32)  # pole leaning
    if family == "unicycle":
        return jnp.asarray([0.0, 0.0, 0.4], jnp.float32)
    if family == "arm":
        return jnp.asarray([-1.5707963, 0.0, 0.0, 0.0], jnp.float32)  # hanging
    if family == "quadrotor":
        return jnp.asarray([-1.0, 0.0, 0.05, 0.2, 0.0, 0.1], jnp.float32)
    if family == "quadrotor3d":
        return jnp.concatenate(
            [jnp.asarray([-1.0, 0.0, 0.5]),
             jnp.asarray([1.0, 0.0, 0.0, 0.0]),     # level
             jnp.asarray([0.2, 0.0, 0.1]), jnp.asarray([0.0, 0.1, 0.0])]
        ).astype(jnp.float32)
    # lti / obstacle (point_mass3d state)
    return jnp.asarray([0.1, -0.2, 0.05, 0.0, 0.0, 0.0], jnp.float32)


def _chained_stats(make_chain, chain_args, iters: int, warmup: int,
                   reps: int) -> dict:
    """Times one solve by differencing two chained-scan lengths.

    Device time per solve without the host's dispatch and fetch: jit a
    `lax.scan` of n receding-horizon solves (each consumes the previous U —
    a real data dependency XLA cannot elide), fetch one scalar, and take
    (t(n_big) − t(n_small)) / (n_big − n_small). Constant dispatch/fetch
    overhead cancels exactly. (The served path's per-cycle time, dispatch
    included, is a different metric: scripts/probe_kernels.py.)

    Statistics are honest paired estimates: rep i runs TWO interleaved
    (small, big) pairs and yields est = mean of the two half-estimates
    (t_big − t_small)/Δn — accepted only when the halves agree within 30 %.
    A transient stall (host preemption) lands in one half
    but almost never in both, so disagreeing halves are discarded and
    re-measured instead of poisoning the tails (round-3 tables showed
    4-13× min..max spreads from exactly this failure mode). We report the
    median, IQR, min and max over `reps` accepted estimates — nothing is
    fabricated from the mean.
    """
    import time

    import numpy as np

    n_small, n_big = max(warmup, 4), max(warmup, 4) + iters
    small, big = make_chain(n_small), make_chain(n_big)

    def timed(f) -> float:
        t0 = time.perf_counter()
        v = float(f(*chain_args))  # float() forces a real device round-trip
        assert np.isfinite(v)
        return time.perf_counter() - t0

    timed(small), timed(big)  # compile + warm
    ests, discarded = [], 0
    while len(ests) < reps and discarded < 3 * reps:
        ts1, tb1 = timed(small), timed(big)
        ts2, tb2 = timed(small), timed(big)
        e1 = (tb1 - ts1) * 1e3 / (n_big - n_small)
        e2 = (tb2 - ts2) * 1e3 / (n_big - n_small)
        if e1 <= 0.0 or e2 <= 0.0:
            # a solve cannot take negative time: a transient stall hit the
            # small-chain run of that half
            discarded += 1
            continue
        if abs(e1 - e2) / min(e1, e2) > 0.30:
            # the halves disagree by >30 %: one of them absorbed a stall;
            # no way to tell which, so drop the whole rep
            discarded += 1
            continue
        ests.append(0.5 * (e1 + e2))
    if not ests:
        # fail loudly rather than emitting NaN statistics into the JSON line
        raise RuntimeError(
            f"no valid paired estimates after {discarded} discarded reps "
            "(persistently stalled runtime?)"
        )
    ests = sorted(ests)
    q25, q75 = float(np.percentile(ests, 25)), float(np.percentile(ests, 75))
    out = {
        "p50_ms": float(np.median(ests)),
        "min_ms": ests[0],
        "max_ms": ests[-1],
        "iqr_ms": q75 - q25,
        "spread_ms": ests[-1] - ests[0],
        "reps": len(ests),
        "estimates_ms": [round(e, 4) for e in ests],
    }
    if discarded:
        out["discarded_reps"] = discarded
    return out


def bench_solve(K: int, T: int, backend: str, iters: int, warmup: int,
                antithetic: bool = False, mesh=None, mlp: bool = False,
                reps: int = 5, family: str = "lti") -> dict:
    """One-robot solve latency via the chained-scan differencing harness
    (:func:`_chained_stats`)."""
    ctrl = build(K, T, backend, antithetic, mesh=mesh, mlp=mlp, family=family)
    x = bench_x0(family)
    U0 = ctrl.init_action_seq()
    key0 = jax.random.key(0)

    def make_chain(n: int):
        @jax.jit
        def chain(x, U):
            def body(U, i):
                res = ctrl._solve(
                    ctrl.dynamics, ctrl.cost, x, U,
                    jax.random.fold_in(key0, i),
                    ctrl.sigma, ctrl.lambda_, ctrl.max_a,
                )
                return res.u_next, res.action[0]
            Uf, acts = jax.lax.scan(body, U, jnp.arange(n))
            return jnp.sum(Uf) + jnp.sum(acts)

        return chain

    return _chained_stats(make_chain, (x, U0), iters, warmup, reps)


def _fmt(s: dict) -> str:
    return (
        f"p50={s['p50_ms']:.3f} ms min={s['min_ms']:.3f} max={s['max_ms']:.3f} "
        f"(spread {s['spread_ms']:.3f} over {s['reps']} reps, "
        f"{1e3 / s['p50_ms']:.1f} solves/s)"
    )


def run_headline(args) -> dict:
    s = bench_solve(args.k, args.t, args.backend, args.iters, args.warmup,
                    args.antithetic, mlp=args.mlp, family=args.family)
    label = "mlp" if args.mlp else args.backend
    if args.family != "lti":
        label += f" ({args.family})"
    print(f"K={args.k} T={args.t} backend={label}: {_fmt(s)}", file=sys.stderr)
    if args.extra:
        s5 = bench_solve(100_000, args.t, args.backend,
                         max(args.iters // 3, 5), 3, args.antithetic,
                         mlp=args.mlp, family=args.family)
        print(f"K=100000 T={args.t}: {_fmt(s5)}", file=sys.stderr)
    metric = f"ms_per_solve_K{args.k}_T{args.t}" + ("_mlp" if args.mlp else "") + (
        f"_{args.family}" if args.family != "lti" else ""
    )
    return {
        "metric": metric,
        "value": round(s["p50_ms"], 4),
        "unit": "ms",
        # the reference baseline is the analytic-LTI point-mass workload; the
        # MLP / pendulum rollouts are different computations — no speedup
        # claim for those
        "vs_baseline": (
            None if (args.mlp or args.family != "lti")
            else round(BASELINE_MS / s["p50_ms"], 2)
        ),
    }


def run_sharded(args) -> dict:
    """Mesh-size sweep: weak scaling (K per device fixed) and strong scaling
    (total K fixed), with efficiency vs the n=1 anchor. The sweep covers
    whatever devices are attached; on a virtual CPU mesh it validates
    shapes and collectives and measures the harness, not a device."""
    from mppi_gpu_tpu.parallel import make_mesh

    ndev = len(jax.devices())
    sizes = [int(n) for n in args.mesh_sizes.split(",") if int(n) <= ndev]
    if not sizes:
        sizes = [1]
    platform = jax.devices()[0].platform
    backend = args.backend if args.backend != "auto" else (
        "pallas" if platform == "gpu" else "scan")
    k_per_dev = args.k // max(sizes)
    rows = []
    for n in sizes:
        mesh = make_mesh(n)
        weak = bench_solve(k_per_dev * n, args.t, backend, args.iters,
                           args.warmup, args.antithetic, mesh=mesh, reps=3)
        strong = bench_solve(args.k, args.t, backend, args.iters,
                             args.warmup, args.antithetic, mesh=mesh, reps=3)
        rows.append({"n": n, "weak_ms": weak["p50_ms"], "strong_ms": strong["p50_ms"]})
        print(
            f"mesh n={n}: weak (K={k_per_dev * n}) p50={weak['p50_ms']:.3f} ms  "
            f"strong (K={args.k}) p50={strong['p50_ms']:.3f} ms",
            file=sys.stderr,
        )
    # efficiency is normalized to the smallest measured mesh (the anchor) —
    # with --mesh-sizes not starting at 1 that anchor is rows[0]["n"], not 1
    n0 = rows[0]["n"]
    t1w, t1s = rows[0]["weak_ms"], rows[0]["strong_ms"]
    for r in rows:
        r["weak_eff"] = round(t1w / r["weak_ms"], 3)
        r["strong_eff"] = round(n0 * t1s / (r["n"] * r["strong_ms"]), 3)
    print(
        f"scaling efficiency (vs n={n0} anchor): "
        + "  ".join(
            f"n={r['n']}: weak {r['weak_eff']:.0%} strong {r['strong_eff']:.0%}"
            for r in rows
        ),
        file=sys.stderr,
    )
    return {
        "metric": f"sharded_scaling_K{args.k}_T{args.t}",
        "value": rows[-1]["weak_eff"],
        "unit": "weak_scaling_efficiency",
        "vs_baseline": None,
        "platform": platform,
        "backend": backend,
        "rows": rows,
    }


def _timed_episode_per_backend(make_ctrl, run_fn):
    """Warm-median episode timing shared by the single-robot and fleet
    modes: per backend, one compile+warm call, then the median of 3 timed
    reps. `run_fn(ctrl)` must hit the jitted-episode cache on repeat calls
    (runner caches the program per controller) — the reps time execution,
    not retracing."""
    import time

    platform = jax.devices()[0].platform
    out, last_res = {}, None
    for backend in ["scan"] + (["pallas"] if platform == "gpu" else []):
        ctrl = make_ctrl(backend)
        run_fn(ctrl)  # compile + warm
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            last_res = run_fn(ctrl)
            reps.append(time.perf_counter() - t0)
        out[backend] = sorted(reps)[1]
    return out, last_res


def _episode_cfg():
    from mppi_gpu_tpu.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(root, "configs", "point_mass2d.yaml"))


def run_episode(args) -> dict:
    """Whole-episode-jit headline: the full 10 s closed loop (500 control
    cycles of solve + world physics at K=3000, T=50) as ONE XLA program,
    timed warm, for both rollout backends."""
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.runner import run_episode_jit

    cfg = _episode_cfg()
    out, res = _timed_episode_per_backend(
        lambda backend: MPPIController(cfg, rollout_backend=backend),
        run_episode_jit,
    )
    assert res.xs.shape[0] > 400
    n = res.us.shape[0]
    for backend, t in out.items():
        print(
            f"episode-jit [{backend}]: {t:.3f} s warm for {n} control "
            f"cycles ({1e3 * t / n:.2f} ms/cycle incl. plant)",
            file=sys.stderr,
        )
    return {
        "metric": "episode_jit_seconds_K3000_T50_500cycles",
        "value": round(min(out.values()), 4),
        "unit": "s",
        "vs_baseline": None,
        "per_backend_s": {k: round(v, 4) for k, v in out.items()},
    }


def bench_fleet_solve(R: int, K: int, T: int, backend: str, iters: int,
                      warmup: int, family: str = "lti", reps: int = 5,
                      antithetic: bool = False, sharded: bool = False) -> dict:
    """Times one whole-fleet solve (R robots x K rollouts each) with the same
    chained-scan differencing harness as :func:`bench_solve`. With
    `sharded`, robots shard over the device mesh as whole robots per chip
    (parallel/fleet.py) — on n=1 this measures the shard_map wrapper's
    overhead over the plain fleet (expected ~zero: no collectives)."""
    from mppi_gpu_tpu.batched import BatchedMPPIController

    cfg = make_cfg(K, T, family, antithetic)
    if sharded:
        from mppi_gpu_tpu.parallel import ShardedFleetController

        ctrl = ShardedFleetController(cfg, R, rollout_backend=backend)
    else:
        ctrl = BatchedMPPIController(cfg, R, rollout_backend=backend)
    x1 = bench_x0(family)
    # distinct per-robot starts: position offsets only, so quaternion states
    # stay unit
    offs = jnp.zeros((R, cfg.state_dim)).at[:, 0].set(
        0.05 * jnp.arange(R, dtype=jnp.float32)
    )
    xs = x1[None, :] + offs
    Us0 = ctrl.init_action_seqs()
    keys0 = ctrl.init_keys()

    def make_chain(n: int):
        @jax.jit
        def chain(xs, Us):
            def body(Us, i):
                keys = jax.vmap(jax.random.fold_in, (0, None))(keys0, i)
                res = ctrl._solve_batch(
                    ctrl.dynamics, ctrl.cost, xs, Us, keys,
                    ctrl.sigma, ctrl.lambda_, ctrl.max_a,
                )
                return res.u_next, res.action[:, 0]
            Uf, acts = jax.lax.scan(body, Us, jnp.arange(n))
            return jnp.sum(Uf) + jnp.sum(acts)

        return chain

    s = _chained_stats(make_chain, (xs, Us0), iters, warmup, reps)
    s["backend"] = ctrl.rollout_backend
    return s


def run_fleet(args) -> dict:
    """Fleet headline: R robots x K rollouts per whole-fleet solve, scan
    (vmap) vs the fused fleet kernels (grid axis 0 = robot axis)."""
    platform = jax.devices()[0].platform
    R, K = args.fleet, args.k
    out = {}
    backends = ["scan"] + (["pallas"] if platform == "gpu" else [])
    for backend in backends:
        try:
            s = bench_fleet_solve(R, K, args.t, backend, args.iters,
                                  args.warmup, family=args.family,
                                  antithetic=args.antithetic,
                                  sharded=args.sharded)
        except Exception as e:  # noqa: BLE001 — e.g. the scan fleet's
            # (R, T, K, a) noise tensor exceeding device memory at scales the
            # fused fleet (in-kernel noise) still runs; that asymmetry IS a
            # result
            print(
                f"fleet R={R} K={K} T={args.t} [{backend}]: FAILED "
                f"({type(e).__name__}: {str(e)[:160]})",
                file=sys.stderr,
            )
            out[backend] = {"failed": type(e).__name__}
            continue
        out[backend] = s
        print(
            f"fleet R={R} K={K} T={args.t} [{backend}"
            + (" + antithetic" if args.antithetic else "")
            + (" + sharded" if args.sharded else "")
            + (f" ({args.family})" if args.family != "lti" else "")
            + f"]: {_fmt(s)} per fleet-solve "
            f"({R * 1e3 / s['p50_ms']:.0f} robot-solves/s)",
            file=sys.stderr,
        )
    ok = [s for s in out.values() if "p50_ms" in s]
    if not ok:
        raise RuntimeError("every fleet backend failed")
    best = min(ok, key=lambda s: s["p50_ms"])
    return {
        "metric": f"ms_per_fleet_solve_R{R}_K{K}_T{args.t}"
        + ("_sharded" if args.sharded else "")
        + (f"_{args.family}" if args.family != "lti" else ""),
        "value": round(best["p50_ms"], 4),
        "unit": "ms",
        "vs_baseline": None,
        "per_backend": {
            b: {k: v for k, v in s.items() if k != "estimates_ms"}
            for b, s in out.items()
        },
    }


def run_fleet_episode(args) -> dict:
    """Whole-fleet-episode headline: R complete 10 s closed loops (500
    control cycles x R solves + R world steps at K=3000, T=50) as ONE XLA
    program, timed warm for both fleet backends."""
    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.runner import run_fleet_episode_jit

    cfg = _episode_cfg()
    R = args.fleet
    out, res = _timed_episode_per_backend(
        lambda backend: BatchedMPPIController(cfg, R, rollout_backend=backend),
        run_fleet_episode_jit,
    )
    n = res.us.shape[0]
    assert n > 400 and res.us.shape[1] == R
    for backend, t in out.items():
        print(
            f"fleet-episode-jit R={R} [{backend}]: {t:.3f} s warm for {n} "
            f"cycles x {R} robots ({1e3 * t / n:.2f} ms/cycle for the whole "
            "fleet)",
            file=sys.stderr,
        )
    return {
        "metric": f"fleet_episode_jit_seconds_R{R}_K3000_T50_500cycles",
        "value": round(min(out.values()), 4),
        "unit": "s",
        "vs_baseline": None,
        "per_backend_s": {k: round(v, 4) for k, v in out.items()},
    }


ALL_CASES = [
    # (K, backend, antithetic, iters, family)
    (10_000, "scan", False, 60, "lti"),
    (10_000, "pallas", False, 60, "lti"),
    (100_000, "scan", False, 20, "lti"),
    (100_000, "pallas", False, 20, "lti"),
    (100_000, "pallas", True, 20, "lti"),
    (1_000_000, "pallas", False, 8, "lti"),
    (100_000, "scan", False, 20, "pendulum"),
    (100_000, "pallas", False, 20, "pendulum"),
    (100_000, "scan", False, 20, "cartpole"),
    (100_000, "pallas", False, 20, "cartpole"),
    (100_000, "scan", False, 20, "obstacle"),
    (100_000, "pallas", False, 20, "obstacle"),
    (100_000, "scan", False, 20, "quadrotor"),
    (100_000, "pallas", False, 20, "quadrotor"),
    (100_000, "scan", False, 20, "quadrotor3d"),
    (100_000, "pallas", False, 20, "quadrotor3d"),
    (100_000, "pallas", True, 20, "quadrotor3d"),
    (100_000, "scan", False, 20, "unicycle"),
    (100_000, "pallas", False, 20, "unicycle"),
    (100_000, "scan", False, 20, "arm"),
    (100_000, "pallas", False, 20, "arm"),
]


def run_all(args) -> dict:
    """Every family at K=10⁵ on both backends (plus the K=10⁴ / 10⁶ lti
    rows and an MLP row), one command. Needs a GPU: the pallas rows are
    the point of the table."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"--all measures the fused GPU kernels; JAX found {platform}")
    results = []
    for K, backend, anti, iters, family in ALL_CASES:
        s = bench_solve(K, args.t, backend, iters, 3, anti, family=family)
        results.append({"K": K, "backend": backend, "antithetic": anti,
                        "family": family, **s})
        tag = backend + (" + antithetic" if anti else "")
        if family != "lti":
            tag += f" [{family}]"
        print(f"K={K:>7} {tag:<22} {_fmt(s)}", file=sys.stderr)
    mlp = bench_solve(10_000, args.t, "scan", 20, 3, mlp=True)
    results.append({"K": 10_000, "backend": "mlp-scan", "antithetic": False,
                    "family": "mlp", **mlp})
    print(f"K=  10000 {'MLP(128x128) scan':<22} {_fmt(mlp)}", file=sys.stderr)
    print(_markdown_table(results, args.t), file=sys.stderr)
    head = next(
        (r for r in results if r["K"] == 10_000 and r["backend"] == "pallas"),
        results[0],
    )
    return {
        "metric": f"ms_per_solve_K10000_T{args.t}",
        "value": round(head["p50_ms"], 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / head["p50_ms"], 2),
        "table": results,
    }


# ---------------------------------------------------------------------------
# Solution-quality regression mode (--quality).
#
# Perf work can silently trade away solution quality with nothing to catch
# it: these are fixed-seed closed-loop episodes
# per family (the jitted episode harness, JAX ground-truth world), reduced
# to a steady-state goal metric + mean visited state cost + a success flag,
# printed as one table. The reference's de-facto
# quality artifact is its trajectory CSV + plots
# (/root/reference/src/main.cu:381-383); this is the tracked-number form.

# planning-time obstacle inflation for the quality episode (see
# _quality_cfg); clearance is scored against the TRUE radii
QUALITY_OBSTACLE_MARGIN = 0.06


def _quality_cfg(family: str):
    from mppi_gpu_tpu.config import load_config

    yamls = {
        "lti": "point_mass3d", "pendulum": "pendulum", "cartpole": "cartpole",
        "quadrotor": "quadrotor", "quadrotor3d": "quadrotor3d",
        "unicycle": "unicycle", "arm": "arm",
    }
    if family == "obstacle":
        # no tuned YAML exists for the obstacle family; quality-gate it at
        # the closed-loop scale of the point-mass configs. The planner sees
        # SAFETY-MARGIN-INFLATED obstacles (standard MPPI deployment
        # practice: the indicator penalty is free right up to the surface,
        # so the softmin optimum tracks it and closed-loop model-plant
        # mismatch would graze a few cm inside the TRUE sphere — measured
        # -0.018 m without the margin); quality_row then scores clearance
        # against the TRUE radii.
        cfg = make_cfg(2048, 50, "obstacle")
        return cfg.replace(obstacles=tuple(
            (*ob[:-1], ob[-1] + QUALITY_OBSTACLE_MARGIN)
            for ob in cfg.obstacles
        ))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", f"{yamls[family]}.yaml")
    return load_config(path)


def _goal_metric(family: str, cfg):
    """(metric fn over a trajectory (N, s) -> (N,) distances, unit label).
    Family-specific 'how far from solved is this state'."""
    import numpy as np

    g = np.asarray(cfg.goal, np.float64)

    def wrap(th):
        return np.abs(np.arctan2(np.sin(th), np.cos(th)))

    if family in ("lti", "obstacle"):
        n = len(cfg.goal) // 2
        return (lambda xs: np.linalg.norm(xs[:, :n] - g[:n], axis=1)), "m"
    if family == "pendulum":
        return (lambda xs: wrap(xs[:, 0])), "rad from upright"
    if family == "cartpole":
        return (lambda xs: wrap(xs[:, 1])), "rad from upright"
    if family == "quadrotor":
        return (lambda xs: np.linalg.norm(xs[:, :2] - g[:2], axis=1)), "m"
    if family == "quadrotor3d":
        return (lambda xs: np.linalg.norm(xs[:, :3] - g[:3], axis=1)), "m"
    if family == "unicycle":
        return (lambda xs: np.linalg.norm(xs[:, :2] - g[:2], axis=1)), "m"
    if family == "arm":
        from mppi_gpu_tpu.models.arm import TwoLinkArmDynamics

        dyn = TwoLinkArmDynamics.create(cfg.dt)

        def ee_dist(xs):
            ee = np.asarray(dyn.end_effector(jnp.asarray(xs, jnp.float32)))
            return np.hypot(ee[:, 0] - g[0], ee[:, 1] - g[1])

        return ee_dist, "m (end effector)"
    raise ValueError(family)


# steady-state success thresholds: regression TRIPWIRES set ~2x above the
# measured steady values at fixed seed (README "Solution quality"), not
# absolute claims — a failing flag means a change made control QUALITY
# materially worse at fixed seed/budget, go look.
QUALITY_THRESHOLDS = {
    "lti": 0.35, "obstacle": 0.5, "pendulum": 0.2, "cartpole": 0.35,
    "quadrotor": 0.5, "quadrotor3d": 0.8, "unicycle": 0.4, "arm": 0.5,
}


def quality_row(family: str, backend: str = "auto", num_steps: int | None = None,
                samples: int | None = None, opt_iters: int | None = None,
                seed: int | None = None) -> dict:
    """One fixed-seed closed-loop episode -> quality metrics dict."""
    import numpy as np

    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.runner import run_episode_jit

    cfg = _quality_cfg(family)
    if samples is not None:
        cfg = cfg.replace(samples=samples)
    if opt_iters is not None:
        cfg = cfg.replace(opt_iters=opt_iters)
    if seed is not None:
        cfg = cfg.replace(seed=seed)
    ctrl = MPPIController(cfg, rollout_backend=backend)
    res = run_episode_jit(ctrl, num_steps=num_steps)
    metric, unit = _goal_metric(family, cfg)
    d = metric(np.asarray(res.xs, np.float64))
    tail = d[-max(len(d) // 4, 1):]
    # mean visited state cost (the controller's own terminal-form state
    # cost evaluated along the CLOSED-LOOP trajectory)
    final_v = jax.vmap(ctrl.cost.final)
    mean_cost = float(jnp.mean(final_v(jnp.asarray(res.xs, jnp.float32))))
    row = {
        "family": family,
        "backend": ctrl.rollout_backend,
        "K": cfg.samples,
        "opt_iters": cfg.opt_iters,
        "steps": len(res.us),
        "steady": round(float(tail.mean()), 4),
        "best": round(float(d.min()), 4),
        "mean_state_cost": round(mean_cost, 3),
        "unit": unit,
        "success": bool(tail.mean() < QUALITY_THRESHOLDS[family]),
    }
    if family == "obstacle":
        # min clearance to any TRUE obstacle surface along the whole
        # closed-loop trajectory (the planner saw margin-inflated spheres)
        # — the quality number the obstacle penalty exists for
        xs = np.asarray(res.xs, np.float64)
        clear = np.inf
        for ob in cfg.obstacles:
            c, r = np.asarray(ob[:3]), ob[3] - QUALITY_OBSTACLE_MARGIN
            clear = min(
                clear, float((np.linalg.norm(xs[:, :3] - c, axis=1) - r).min())
            )
        row["min_clearance"] = round(clear, 4)
        row["success"] = row["success"] and clear > 0.0
    return row


QUALITY_FAMILIES = ("lti", "obstacle", "pendulum", "cartpole", "quadrotor",
                    "quadrotor3d", "unicycle", "arm")


def run_quality(args) -> dict:
    """Fixed-seed closed-loop quality table + the iterated-MPPI fixed-budget
    comparison (same rollout budget: 1x1024 vs 4x256 on pendulum swing-up —
    commit f6ae273's result, now a tracked row)."""
    rows = [quality_row(f, backend=args.backend) for f in QUALITY_FAMILIES]
    for r in rows:
        print(
            f"[{r['family']:<12}] steady={r['steady']:.3f} {r['unit']:<18} "
            f"best={r['best']:.3f} mean-cost={r['mean_state_cost']:.2f} "
            f"{'OK' if r['success'] else 'REGRESSED'}",
            file=sys.stderr,
        )
    it_rows = []
    for K, M in ((1024, 1), (256, 4)):
        r = quality_row("pendulum", backend=args.backend, samples=K, opt_iters=M)
        r["family"] = f"pendulum {M}x{K}"
        it_rows.append(r)
        print(
            f"[iterated {M}x{K:<5}] steady={r['steady']:.3f} rad "
            f"best={r['best']:.3f}",
            file=sys.stderr,
        )
    print(_quality_table(rows, it_rows), file=sys.stderr)
    ok = sum(r["success"] for r in rows)
    return {
        "metric": "quality_families_ok",
        "value": ok,
        "unit": f"of {len(rows)} families",
        "vs_baseline": None,
        "table": rows + it_rows,
    }


def _quality_table(rows: list[dict], it_rows: list[dict]) -> str:
    lines = [
        "| Episode (fixed seed, full 10 s closed loop) | Backend | K x iters "
        "| steady-state goal metric | best | mean state cost | success |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows + it_rows:
        extra = (
            f" (min obstacle clearance {r['min_clearance']:+.2f} m)"
            if "min_clearance" in r else ""
        )
        lines.append(
            f"| {r['family']} | {r['backend']} | {r['K']}x{r['opt_iters']} "
            f"| {r['steady']:.3f} {r['unit']}{extra} | {r['best']:.3f} "
            f"| {r['mean_state_cost']:.2f} "
            f"| {'yes' if r['success'] else '**REGRESSED**'} |"
        )
    return "\n".join(lines)


def _markdown_table(results: list[dict], T: int) -> str:
    lines = [
        "| Workload | Backend | ms/solve (p50) | IQR | min..max | vs reference ~300 ms |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        tag = {"scan": "XLA scan", "pallas": "fused Pallas", "mlp-scan":
               "MLP(128x128) scan"}[r["backend"]]
        if r["antithetic"]:
            tag += " + antithetic"
        fam = r.get("family", "lti")
        work = f"K=10^{len(str(r['K'])) - 1}, T={T}"
        if fam not in ("lti", "mlp"):
            work += f" ({fam})"
        vs = (
            f"{BASELINE_MS / r['p50_ms']:.0f}x"
            if r["K"] == 10_000 and fam == "lti" else "—"
        )
        lines.append(
            f"| {work} | {tag} | {r['p50_ms']:.2f} | {r['iqr_ms']:.2f} "
            f"| {r['min_ms']:.2f}..{r['max_ms']:.2f} | {vs} |"
        )
    return "\n".join(lines)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=10_000)
    p.add_argument("--t", type=int, default=200)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "scan", "pallas", "pallas-interpret"))
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--extra", action="store_true", help="also bench K=1e5")
    p.add_argument("--antithetic", action="store_true", help="mirrored noise pairs")
    p.add_argument("--mlp", action="store_true",
                   help="MLP(128x128) residual dynamics instead of analytic LTI")
    p.add_argument("--family", default="lti",
                   choices=("lti", "pendulum", "cartpole", "obstacle", "quadrotor",
                            "quadrotor3d", "unicycle", "arm"),
                   help="fused model family for the workload")
    p.add_argument("--sharded", action="store_true",
                   help="mesh-size sweep with weak/strong scaling efficiency")
    p.add_argument("--fleet", type=int, default=0, metavar="R",
                   help="fleet mode: R robots x K rollouts per solve, scan "
                   "(vmap) vs the fused fleet kernels")
    p.add_argument("--episode", action="store_true",
                   help="whole-episode-jit headline (10 s closed loop, one "
                   "XLA program) for both backends")
    p.add_argument("--quality", action="store_true",
                   help="solution-quality regression table: fixed-seed "
                   "closed-loop episode per family + the iterated-MPPI "
                   "fixed-budget comparison")
    p.add_argument("--mesh-sizes", default="1,2,4,8")
    p.add_argument("--all", action="store_true",
                   help="per-family table, both backends (needs a GPU)")
    return p


def main() -> int:
    args = _build_parser().parse_args()
    from mppi_gpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}", file=sys.stderr)

    if args.fleet and args.sharded:
        out = run_fleet(args)
    elif args.sharded:
        out = run_sharded(args)
    elif args.fleet and args.episode:
        out = run_fleet_episode(args)
    elif args.fleet:
        out = run_fleet(args)
    elif args.episode:
        out = run_episode(args)
    elif args.quality:
        out = run_quality(args)
    elif args.all:
        out = run_all(args)
    else:
        out = run_headline(args)
    out["device"] = device
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
