"""bench.py's config surface: every benchmark case must build a valid
controller, and the per-family initial states must match the configs —
a table row that cannot build is a silent hole in the --all table."""

from __future__ import annotations

import sys

sys.path.insert(0, ".")  # bench.py lives at the repo root

import jax.numpy as jnp
import pytest

import bench


@pytest.mark.parametrize("family", sorted({c[4] for c in bench.ALL_CASES}))
def test_every_all_cases_family_builds_and_solves(family):
    cfg = bench.make_cfg(64, 6, family)
    assert cfg.samples == 64 and cfg.horizon == 6
    ctrl = bench.build(64, 6, "scan", family=family)
    x = bench.bench_x0(family)
    assert x.shape == (cfg.state_dim,)
    res = ctrl.solve(x, ctrl.init_action_seq(), ctrl.init_key())
    assert res.action.shape == (cfg.action_dim,)
    assert bool(jnp.all(jnp.isfinite(res.action)))


def test_mlp_case_builds():
    ctrl = bench.build(64, 6, "scan", mlp=True)
    x = bench.bench_x0("lti")
    res = ctrl.solve(x, ctrl.init_action_seq(), ctrl.init_key())
    assert bool(jnp.all(jnp.isfinite(res.action)))


def test_chained_stats_reports_honest_spread():
    """The harness must report genuine paired estimates (n reps, sorted,
    min<=p50<=max) — no fabricated statistics (round-1 verdict item)."""
    import jax

    def make_chain(n):
        @jax.jit
        def chain(x):
            def body(c, _):
                # enough per-iteration work that t(n_big) > t(n_small)
                # reliably on any host (negative paired estimates would be
                # discarded, shrinking `reps`)
                v = c + jnp.sum(jnp.sin(x + c * jnp.arange(20_000.0)))
                return v * 1e-6, v
            cf, _ = jax.lax.scan(body, x, None, length=n * 40)
            return cf
        return chain

    s = bench._chained_stats(make_chain, (jnp.float32(1.0),), iters=6,
                             warmup=2, reps=3)
    # under xdist host load some paired reps get discarded (that IS the
    # honesty mechanism working) — require at least one accepted rep and
    # consistent bookkeeping, not an exact count
    assert 1 <= s["reps"] <= 3 and len(s["estimates_ms"]) == s["reps"]
    assert s["min_ms"] <= s["p50_ms"] <= s["max_ms"]
    assert s["min_ms"] > 0.0


def test_all_refuses_to_run_off_the_gpu():
    """--all measures the fused GPU kernels: on the CPU it must fail, not
    quietly drop the pallas rows."""
    args = bench._build_parser().parse_args(["--all"])
    with pytest.raises(SystemExit, match="GPU"):
        bench.run_all(args)


def test_markdown_table_renders_from_results():
    results = [
        {"K": 10_000, "backend": "scan", "family": "lti", "antithetic": False,
         "p50_ms": 1.0, "iqr_ms": 0.1, "min_ms": 0.9, "max_ms": 1.2},
        {"K": 100_000, "backend": "pallas", "family": "pendulum",
         "antithetic": True, "p50_ms": 2.0, "iqr_ms": 0.1, "min_ms": 1.9,
         "max_ms": 2.2},
    ]
    table = bench._markdown_table(results, 200)
    assert "| K=10^4, T=200 | XLA scan | 1.00 |" in table
    assert "fused Pallas + antithetic" in table and "(pendulum)" in table


def test_quality_row_machinery_cpu():
    """quality_row end-to-end on CPU at toy scale: metrics finite, keyed,
    and the success flag is a real threshold comparison."""
    r = bench.quality_row("pendulum", backend="scan", num_steps=25, samples=64)
    for k in ("steady", "best", "mean_state_cost", "steps", "success"):
        assert k in r, r
    assert r["steps"] == 25 and r["backend"] == "scan"
    assert 0.0 <= r["best"] <= r["steady"] + 5.0
    assert r["success"] == (r["steady"] < bench.QUALITY_THRESHOLDS["pendulum"])
    # the obstacle row must score clearance against the TRUE radii while
    # the planner saw margin-inflated ones
    r2 = bench.quality_row("obstacle", backend="scan", num_steps=10, samples=64)
    assert "min_clearance" in r2
    cfg = bench._quality_cfg("obstacle")
    base = bench.make_cfg(2048, 50, "obstacle")
    for ob_inflated, ob_true in zip(cfg.obstacles, base.obstacles):
        assert abs(
            ob_inflated[-1] - ob_true[-1] - bench.QUALITY_OBSTACLE_MARGIN
        ) < 1e-9


def test_quality_metric_definitions():
    """Every quality family has a metric fn + threshold, and the metric
    maps a goal-state trajectory to ~zero distance."""
    import numpy as np

    for fam in bench.QUALITY_FAMILIES:
        cfg = bench._quality_cfg(fam)
        assert fam in bench.QUALITY_THRESHOLDS
        metric, unit = bench._goal_metric(fam, cfg)
        if fam in ("lti", "obstacle", "quadrotor", "quadrotor3d", "unicycle"):
            # trajectory sitting exactly at the goal-position -> 0
            x = np.zeros((3, cfg.state_dim))
            x[:, : len(cfg.goal)] = np.asarray(cfg.goal)
            if fam == "quadrotor3d":
                x[:, : 3] = np.asarray(cfg.goal)[:3]
            np.testing.assert_allclose(metric(x), 0.0, atol=1e-6)
        elif fam in ("pendulum", "cartpole"):
            x = np.zeros((3, cfg.state_dim))
            np.testing.assert_allclose(metric(x), 0.0, atol=1e-6)
