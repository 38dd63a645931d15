"""Smoke test of the MPPI controller on NVIDIA GPUs: drives the main path
once, phase by phase, and checks what comes out.

    python chip_smoke.py              # one GPU: phases 1-4
    python chip_smoke.py --cards 4    # four GPUs: phase 1 and the sharded phase 5

Phases (each prints one result line; any failure exits non-zero):

1. device   — JAX's devices must be GPUs (never falls back to the CPU);
              prints the card's name and power limit from nvidia-smi.
2. cli      — the CLI closed loop on every shipped config, `auto` backend:
              the state must move toward the goal.
3. kernels  — every fused family's kernels (K=10⁴ and 10⁵, T=200) and the
              R=8 fleet against the plain scan reference fed the same ε;
              the MLP dynamics' default-precision deviation from `highest`.
4. full     — full-width solves: point_mass3d K=10⁴ T=200, lti K=10⁶ T=200
              (with its compiled memory analysis), the R=8 fleet at K=10⁵,
              the sharded controller on a one-card mesh, --jit-episode.
5. cards    — (``--cards 4`` only) the K-sharded solve of lti K=10⁶ over
              four cards against a one-card replay of each shard, and the
              robot-sharded quadrotor3d fleet (R=64) against each robot
              solved alone.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "configs")

# Tolerances of phase 3 (kernel against the plain reference, same ε).
# S, per rollout, rel = |ΔS| / (|S_ref| + S_ATOL/S_RTOL): the median rel must
# be ≤ S_MED and at least S_FRAC of the rollouts must have rel ≤ S_RTOL.
# Both sides are f32 sums over T=200 steps; the kernel advances angles by
# small-angle Taylor additions where the reference calls sin/cos, and the
# card's transcendentals differ from XLA's in the last bits. A cart-pole
# whose pole falls is chaotic: those last bits grow along the horizon in a
# few rollouts, on both sides — against a float64 rollout (CPU, K=4000,
# T=200, antithetic+OU) the kernel's worst rel is 4.6e-3 and the f32 scan's
# 1.2e-2, medians 4.9e-7 and 5.7e-7. So no bound holds for every rollout;
# the median catches a wrong step, the fraction a wrong branch. Such
# rollouts cost the most and carry no softmin weight, so ΔU matches tightly.
S_RTOL, S_ATOL, S_FRAC, S_MED = 1e-3, 1e-3, 0.99, 1e-5
# ΔU: |ΔU − ΔU_ref| ≤ DU_TOL·max|ΔU_ref| + 1e-6. Sums over K taken per block
# and then across blocks, in another order than the reference's contraction;
# the weights come from the kernel's own S.
DU_TOL = 1e-4
# MLP dynamics at default matmul precision (TF32 on this card) against
# `highest`, relative to the largest residual: TF32 keeps 10 mantissa bits.
MLP_TOL = 2e-2


def _say(msg: str) -> None:
    print(msg, flush=True)


def _phase(name: str, fn, *args):
    t0 = time.perf_counter()
    detail = fn(*args)
    _say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {detail}")


def _gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 1
def phase_device(cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    if len(devs) < cards:
        raise SystemExit(f"--cards {cards} needs {cards} GPUs, JAX found {len(devs)}")
    _say(_gpu_name_and_limit())
    return f"{len(devs)} x {devs[0].device_kind}"


# ---------------------------------------------------------------- phase 2
def phase_cli(steps: int = 60):
    """Progress toward the goal = distance to the goal over the state
    components the task moves (those where the start differs from the goal);
    its minimum over the second half of the run must be below the start's
    (a minimum, because the pendulum swings up through ±π)."""
    import numpy as np

    from mppi_gpu_tpu.cli import main as cli_main
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.envs import make_jax_world
    from mppi_gpu_tpu.io.csvio import read_csv_columns

    rows = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for path in sorted(glob.glob(os.path.join(CONFIGS, "*.yaml"))):
            cfg, name = load_config(path), os.path.basename(path)[:-5]
            csv = os.path.join(tmp, "traj.csv")
            rc = cli_main(["-c", path, "-t", csv, "--max-steps", str(steps)])
            if rc != 0:
                raise RuntimeError(f"{name}: CLI exited {rc}")
            cols = read_csv_columns(csv)
            xs = np.stack([cols[f"x[{i}]"] for i in range(cfg.state_dim)], axis=1)
            goal = np.zeros(cfg.state_dim)
            goal[: len(cfg.goal)] = cfg.goal
            x0 = np.asarray(make_jax_world(cfg).reset().x)
            moved = np.abs(x0 - goal) > 1e-6
            d0 = float(np.linalg.norm((x0 - goal)[moved]))
            d = np.linalg.norm((xs - goal)[:, moved], axis=1)
            d_late = float(d[len(d) // 2:].min())
            # the reference's unit-test config (K=3) checks arithmetic, not
            # control: it only has to stay finite
            if not np.isfinite(xs).all() or (d_late >= d0 and cfg.samples > 3):
                raise RuntimeError(
                    f"{name}: distance to goal {d0:.4g} -> {d_late:.4g} "
                    f"after {steps} steps (no progress toward the goal)"
                )
            rows.append(f"{name} {d0:.3g}->{d_late:.3g}")
    return "; ".join(rows)


# ---------------------------------------------------------------- phase 3
def _family_problems():
    """(name, dyn, cost, x0, sigma) for every built-in fused family."""
    import jax.numpy as jnp

    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.ops.cost import ObstacleCost
    from mppi_gpu_tpu.envs import make_jax_world

    out = []
    for name in ("point_mass3d", "pendulum", "cartpole", "quadrotor",
                 "quadrotor3d", "unicycle", "arm"):
        cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"))
        c = MPPIController(cfg, rollout_backend="scan")
        out.append((name, c.dynamics, c.cost, make_jax_world(cfg).reset().x, c.sigma))
    cfg = load_config(os.path.join(CONFIGS, "point_mass2d.yaml"))
    c = MPPIController(cfg, rollout_backend="scan")
    obst = ObstacleCost(
        base=c.cost, centers=jnp.asarray([[0.5, 0.5], [1.0, -0.2]]),
        radii=jnp.asarray([0.3, 0.25]), penalty=jnp.float32(50.0),
    )
    out.append(("lti-obstacle", c.dynamics, obst, make_jax_world(cfg).reset().x, c.sigma))
    return out


def _compare(tag, S, dU, S_ref, dU_ref):
    import numpy as np

    S, dU, S_ref, dU_ref = (np.asarray(a, np.float64) for a in (S, dU, S_ref, dU_ref))
    rel = np.abs(S - S_ref) / (np.abs(S_ref) + S_ATOL / S_RTOL)
    n_off = int((rel > S_RTOL).sum())
    s_med, s_max = float(np.median(rel)), float(rel.max())
    du_scale = float(np.max(np.abs(dU_ref)))
    du_rel = float(np.max(np.abs(dU - dU_ref))) / max(du_scale, 1e-30)
    if (not np.isfinite(S).all() or n_off > (1 - S_FRAC) * S.size
            or s_med > S_MED):
        raise RuntimeError(f"{tag}: S off the reference at {n_off} rollouts "
                           f"(median rel {s_med:.3g}, max {s_max:.3g})")
    if not np.abs(dU - dU_ref).max() <= DU_TOL * du_scale + 1e-6:
        raise RuntimeError(f"{tag}: dU off the reference (rel {du_rel:.3g})")
    return (f"{tag} S rel median {s_med:.1e} max {s_max:.1e} "
            f"({n_off} past {S_RTOL:g}) dU rel {du_rel:.1e}")


def phase_kernels(Ks=(10_000, 100_000), T: int = 200, fleet_R: int = 8,
                  interpret: bool = False):
    import jax
    import jax.numpy as jnp

    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.noise import noise_tensor
    from mppi_gpu_tpu.ops.rollout import rollout_costs
    from mppi_gpu_tpu.ops.softmin import softmin_weights

    rows = []

    def spread_lambda(S):
        """A softmin temperature at the cost spread (half the interquartile
        range), so that many rollouts carry weight and the ΔU check sees a
        real weighted sum, not one rollout's ε."""
        q25, q75 = jnp.percentile(S, jnp.asarray([25.0, 75.0]))
        return jnp.maximum(0.5 * (q75 - q25), 1e-3)

    @jax.jit
    def reference(dyn, cost, x0, U, eps, w):
        with jax.default_matmul_precision("highest"):
            S = rollout_costs(dyn, cost, x0, U, eps)
            dU = jnp.einsum("tka,k->ta", eps, w, precision=jax.lax.Precision.HIGHEST)
        return S, dU

    for name, dyn, cost, x0, sigma in _family_problems():
        a = dyn.action_dim
        t = jnp.arange(T, dtype=jnp.float32)[:, None]
        U = 0.2 * jnp.sin(0.05 * t + jnp.arange(a, dtype=jnp.float32))
        for i, K in enumerate(Ks):
            anti, ou = (False, 0.0) if i == 0 else (True, 0.5)
            key = jax.random.key(17 + i)
            plan = fr.plan_for(dyn, cost, K, T, a, antithetic=anti, ou_beta=ou)
            words = fr.robot_words(key[None])
            prow = fr.pack_rows(dyn, cost, x0[None], sigma, plan)
            S = fr.fused_costs(words, U[None], prow, plan, interpret=interpret)[0]
            w = softmin_weights(S, spread_lambda(S[:K])).weights
            dU = fr.fused_update(words, prow, w[None], plan, interpret=interpret)[0]
            eps = noise_tensor(key, T, K, a, sigma, antithetic=anti, ou_beta=ou)
            S_ref, dU_ref = reference(dyn, cost, x0, U, eps, w[:K])
            tag = f"{name} K={K}" + (" anti+ou" if anti else "")
            rows.append(_compare(tag, S[:K], dU, S_ref, dU_ref))

    # the fleet: R robots in one launch of each kernel, each robot against
    # its own reference solve
    name, dyn, cost, x0, sigma = _family_problems()[4]  # quadrotor3d
    K, a = Ks[-1], dyn.action_dim
    keys = jax.random.split(jax.random.key(5), fleet_R)
    xs = x0[None] + 0.05 * jnp.arange(fleet_R, dtype=jnp.float32)[:, None]
    Us = 0.1 * jnp.cos(0.03 * jnp.arange(fleet_R * T * a, dtype=jnp.float32)).reshape(
        fleet_R, T, a)
    plan = fr.plan_for(dyn, cost, K, T, a, R=fleet_R)
    words = fr.robot_words(keys)
    prow = fr.pack_rows(dyn, cost, xs, sigma, plan)
    S = fr.fused_costs(words, Us, prow, plan, interpret=interpret)
    w = jax.vmap(lambda s: softmin_weights(s, spread_lambda(s[:K])).weights)(S)
    dU = fr.fused_update(words, prow, w, plan, interpret=interpret)
    worst = []
    for r in range(fleet_R):
        eps = noise_tensor(keys[r], T, K, a, sigma)
        S_ref, dU_ref = reference(dyn, cost, xs[r], Us[r], eps, w[r, :K])
        worst.append(_compare(f"fleet r={r}", S[r, :K], dU[r], S_ref, dU_ref))
    rows.append(f"fleet {name} R={fleet_R} K={K} ok")
    rows.append(_mlp_precision())
    return "\n  " + "\n  ".join(rows + worst)


def _mlp_precision() -> str:
    """Deviation of the MLP dynamics at the default matmul precision from
    `highest`, on a random (not zero-output) net."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mppi_gpu_tpu.models.neural import init_mlp_dynamics

    mlp = init_mlp_dynamics(jax.random.key(0), 6, 3, hidden=(128, 128))
    w_last = 0.1 * jax.random.normal(jax.random.key(1), mlp.weights[-1].shape)
    mlp = mlp.__class__(
        weights=mlp.weights[:-1] + (w_last,), biases=mlp.biases,
        residual_scale=mlp.residual_scale, state_dim=6, action_dim=3,
    )
    x = jax.random.normal(jax.random.key(2), (10_000, 6))
    u = jax.random.normal(jax.random.key(3), (10_000, 3))
    step = jax.jit(mlp.step)
    default = np.asarray(step(x, u) - x)
    with jax.default_matmul_precision("highest"):
        high = np.asarray(jax.jit(mlp.step)(x, u) - x)
    rel = float(np.max(np.abs(default - high)) / np.max(np.abs(high)))
    if not rel <= MLP_TOL:
        raise RuntimeError(f"MLP default precision deviates {rel:.3g} > {MLP_TOL}")
    return f"mlp default-vs-highest rel {rel:.2e} (tol {MLP_TOL})"


# ---------------------------------------------------------------- phase 4
def _check_result(tag, res, max_a):
    import numpy as np

    act = np.asarray(res.action)
    if not np.isfinite(act).all() or (np.abs(act) > np.asarray(max_a) + 1e-6).any():
        raise RuntimeError(f"{tag}: bad action {act}")
    if not np.isfinite(np.asarray(res.u_next)).all():
        raise RuntimeError(f"{tag}: non-finite u_next")


def _timed_solves(ctrl, x, n: int = 5):
    import jax
    import numpy as np

    U, key = ctrl.init_action_seq(), ctrl.init_key()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        res = ctrl.solve_auto(x, U, key, i)
        jax.block_until_ready(res.action)
        times.append(time.perf_counter() - t0)
        U = res.u_next
    return res, float(np.median(times[1:]) * 1e3)


def phase_full(K_small: int = 10_000, K_big: int = 1_000_000,
               fleet_K: int = 100_000, T: int = 200, backend: str = "auto"):
    import jax
    import jax.numpy as jnp

    from mppi_gpu_tpu.batched import BatchedMPPIController
    from mppi_gpu_tpu.cli import main as cli_main
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.envs import make_jax_world
    from mppi_gpu_tpu.parallel import ShardedMPPIController
    from mppi_gpu_tpu.parallel.mesh import make_mesh

    rows = []
    pm3 = load_config(os.path.join(CONFIGS, "point_mass3d.yaml"))
    x0 = make_jax_world(pm3).reset().x
    want = "pallas" if backend == "auto" else backend
    for K in (K_small, K_big):
        cfg = pm3.replace(samples=K, horizon=T)
        ctrl = MPPIController(cfg, rollout_backend=backend)
        if ctrl.rollout_backend != want:
            raise RuntimeError(f"auto resolved to {ctrl.rollout_backend} on the GPU")
        res, ms = _timed_solves(ctrl, x0)
        _check_result(f"lti K={K}", res, cfg.max_a)
        rows.append(f"lti K={K} T={T} {ctrl.rollout_backend} {ms:.3f} ms/solve")
        if K == K_big:
            comp = ctrl._solve.lower(
                ctrl.dynamics, ctrl.cost, x0, ctrl.init_action_seq(),
                ctrl.init_key(), ctrl.sigma, ctrl.lambda_, ctrl.max_a,
            ).compile()
            rows.append(f"K={K} memory_analysis: {comp.memory_analysis()}")

    q3 = load_config(os.path.join(CONFIGS, "quadrotor3d.yaml")).replace(
        samples=fleet_K, horizon=T, opt_iters=1)
    fleet = BatchedMPPIController(q3, 8, rollout_backend=backend)
    xs = jnp.broadcast_to(make_jax_world(q3).reset().x, (8, q3.state_dim))
    Us, keys = fleet.init_action_seqs(), fleet.init_keys()
    for i in range(3):
        res = fleet.solve_batch_auto(xs, Us, keys, i)
        Us = res.u_next
    jax.block_until_ready(res.action)
    for r in range(8):
        _check_result(f"fleet r={r}", jax.tree_util.tree_map(lambda a: a[r], res), q3.max_a)
    rows.append(f"fleet quadrotor3d R=8 K={fleet_K} T={T} {fleet.rollout_backend}")

    sh = ShardedMPPIController(pm3.replace(samples=K_small, horizon=T),
                               mesh=make_mesh(1),
                               rollout_backend=backend)
    res, ms = _timed_solves(sh, x0)
    _check_result("sharded", res, pm3.max_a)
    rows.append(f"sharded 1-card mesh lti K={K_small} {sh.rollout_backend} {ms:.3f} ms/solve")

    rc = cli_main(["-c", os.path.join(CONFIGS, "point_mass3d.yaml"),
                   "--jit-episode", "--max-steps", "60"])
    if rc != 0:
        raise RuntimeError(f"--jit-episode exited {rc}")
    rows.append("cli --jit-episode point_mass3d ok")
    return "\n  " + "\n  ".join(rows)


# ---------------------------------------------------------------- phase 5
def phase_cards(n: int = 4, K: int = 1_000_000, T: int = 200, per_card: int = 16,
                backend: str = "auto"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController
    from mppi_gpu_tpu.envs import make_jax_world
    from mppi_gpu_tpu.ops import fused_rollout as fr
    from mppi_gpu_tpu.ops.softmin import softmin_weights
    from mppi_gpu_tpu.parallel import ShardedFleetController, ShardedMPPIController
    from mppi_gpu_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n)
    cfg = load_config(os.path.join(CONFIGS, "point_mass3d.yaml")).replace(
        samples=K, horizon=T)
    sh = ShardedMPPIController(cfg, mesh=mesh, rollout_backend=backend)
    interpret = sh.rollout_backend == "pallas-interpret"
    x0 = make_jax_world(cfg).reset().x
    U, key = sh.init_action_seq(), sh.init_key()
    res = sh.solve(x0, U, key)
    jax.block_until_ready(res.action)

    # one-card replay: shard d drew its K/n rollouts from fold_in(key, d)
    dev0 = jax.devices()[0]
    K_loc = cfg.samples // n
    T, a = U.shape

    @jax.jit
    def replay(x0, U, key):
        plan = fr.plan_for(sh.dynamics, sh.cost, K_loc, T, a)
        words = fr.robot_words(jnp.stack([jax.random.fold_in(key, d) for d in range(n)]))
        rows = fr.pack_rows(sh.dynamics, sh.cost, x0[None], sh.sigma, plan)
        S = jnp.stack([
            fr.fused_costs(words[d:d + 1], U[None], rows, plan, interpret=interpret)[0]
            for d in range(n)
        ])
        w = softmin_weights(S.reshape(-1), sh.lambda_).weights.reshape(n, -1)
        dU = sum(fr.fused_update(words[d:d + 1], rows, w[d:d + 1], plan,
                                 interpret=interpret)[0]
                 for d in range(n))
        return jnp.clip(U + dU, -sh.max_a, sh.max_a)

    u_rep = replay(*jax.device_put((x0, U, key), dev0))
    err = float(np.max(np.abs(np.asarray(res.info.u_seq) - np.asarray(u_rep))))
    if not err <= 1e-5:
        raise RuntimeError(f"sharded K=1e6 differs from its one-card replay by {err:.3g}")
    rows = [f"K-sharded lti K={K} T={T} over {n} cards ({sh.rollout_backend}) "
            f"vs one-card replay: max |du| {err:.2e}"]

    q3 = load_config(os.path.join(CONFIGS, "quadrotor3d.yaml")).replace(opt_iters=1)
    R = per_card * n
    fleet = ShardedFleetController(q3, R, mesh=mesh, rollout_backend=backend)
    xs = jnp.broadcast_to(make_jax_world(q3).reset().x, (R, q3.state_dim))
    xs = xs + 0.01 * jnp.arange(R, dtype=jnp.float32)[:, None]
    Us, keys = fleet.init_action_seqs(), fleet.init_keys()
    u_fleet = np.asarray(fleet.solve_batch(xs, Us, keys).u_next)
    single = MPPIController(q3, rollout_backend=backend)
    xs, Us = np.asarray(xs), np.asarray(Us)
    worst = 0.0
    for r in range(R):
        one = single.solve(*jax.device_put((xs[r], Us[r], keys[r]), dev0))
        worst = max(worst, float(np.max(np.abs(np.asarray(one.u_next) - u_fleet[r]))))
    if not worst <= 1e-5:
        raise RuntimeError(f"sharded fleet differs from single-robot solves by {worst:.3g}")
    rows.append(f"robot-sharded quadrotor3d R={R} ({fleet.rollout_backend}) vs "
                f"each robot alone: max |du| {worst:.2e}")
    return "\n  " + "\n  ".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the four-card sharded phase")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from mppi_gpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    _phase("device", phase_device, args.cards)
    if args.cards == 4:
        _phase("cards", phase_cards, 4)
    else:
        _phase("cli", phase_cli)
        _phase("kernels", phase_kernels)
        _phase("full", phase_full)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
