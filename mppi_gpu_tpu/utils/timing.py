"""Per-solve timing — reproduces the reference's "Average controller execution
time" metric (reference src/main.cu:222-224, 329-332, 376-379) and adds
percentiles + optional `jax.profiler` trace capture."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import numpy as np


@dataclass
class SolveTimer:
    """Accumulates wall-clock timings of the solve (device work included —
    callers must block on results; see `time_fn`)."""

    samples_ms: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.samples_ms)) if self.samples_ms else float("nan")

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(self.samples_ms, q)) if self.samples_ms else float("nan")

    def summary(self, *, split_first: bool = False) -> dict[str, float]:
        """Timing summary. With `split_first` (the interactive loop), the
        first sample — which includes jit compilation — is reported
        separately as `first_ms` and excluded from the statistics, so the
        mean describes the steady-state solve and cannot be read as a
        compile-inflated number (the reference's metric has no compile
        step to hide, src/main.cu:329-332)."""
        samples = self.samples_ms
        out: dict[str, float] = {}
        if split_first and len(samples) >= 2:
            out["first_ms"] = samples[0]
            samples = samples[1:]
        sub = SolveTimer(samples)
        out.update(
            n=len(samples),
            mean_ms=sub.mean_ms,
            p50_ms=sub.percentile_ms(50),
            p95_ms=sub.percentile_ms(95),
            min_ms=sub.percentile_ms(0),
        )
        return out


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    warmup: int = 3,
    **kwargs: Any,
) -> dict[str, float]:
    """Time `fn(*args)` with proper device blocking: warms up (compile), then
    measures `iters` calls, blocking on every output leaf."""

    def block(out: Any) -> None:
        for leaf in jax.tree_util.tree_leaves(out):
            if hasattr(leaf, "block_until_ready"):
                leaf.block_until_ready()

    for _ in range(warmup):
        block(fn(*args, **kwargs))
    timer = SolveTimer()
    for _ in range(iters):
        with timer.measure():
            block(fn(*args, **kwargs))
    return timer.summary()


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional `jax.profiler` trace (the reference has no profiler hooks; this
    is how you see the device timeline)."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
