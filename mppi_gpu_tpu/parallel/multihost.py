"""Multi-host bootstrap: `jax.distributed.initialize` → global mesh →
:class:`~mppi_gpu_tpu.parallel.sharded.ShardedMPPIController`.

The reference has no distributed story at all (one process, one GPU —
reference src/point_mass.cu:265 is its only parallelism); this module is
the multi-process path: every process runs the SAME program,
`init_multihost()` wires the processes into one JAX runtime, and
`jax.devices()` then returns the GLOBAL device list — `make_mesh()` over it
spans processes, K shards across all of them, and the three per-solve
all-reduces (pmin β, psum η, psum ΔU ≤ a few KB) run exactly as on a single
process (docs/scaling.md).

Nothing else in the framework changes: `ShardedMPPIController` is already
mesh-size-agnostic, and every host executes the same replicated closed
loop (per-host RNG decorrelation happens inside the sharded solve via
`fold_in(key, axis_index)`).
"""

from __future__ import annotations

import jax

from mppi_gpu_tpu.parallel.mesh import make_mesh

_INITIALIZED: tuple | None = None  # the args of the successful first call


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Idempotent `jax.distributed.initialize` wrapper.

    Pass all three explicitly (``coordinator_address`` as ``host:port``).
    With no arguments JAX auto-discovers them only under a cluster manager
    it knows (e.g. SLURM); elsewhere, GPU machines included, the call
    fails.

    Must run before the JAX backend initializes (i.e. before the first
    `jax.devices()` / array op); calling it after that point raises a
    RuntimeError from JAX itself, which is surfaced unchanged.

    Returns ``(process_index, process_count)``.
    """
    global _INITIALIZED
    args = (coordinator_address, num_processes, process_id)
    if _INITIALIZED is None:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)
        _INITIALIZED = args
    elif args != (None, None, None) and args != _INITIALIZED:
        # a no-arg re-call is a benign "give me my coordinates"; a re-call
        # with DIFFERENT wiring is a misconfiguration — surface it instead
        # of silently returning the existing runtime's coordinates
        raise RuntimeError(
            f"init_multihost already initialized with {_INITIALIZED}; "
            f"conflicting re-initialization with {args}"
        )
    return jax.process_index(), jax.process_count()


def global_mesh(axis_name: str = "k"):
    """1-D rollout mesh over ALL devices of ALL processes (call after
    :func:`init_multihost`)."""
    return make_mesh(axis_name=axis_name, devices=jax.devices())


def is_coordinator() -> bool:
    """True on the process that should own printing / CSV / checkpoints."""
    return jax.process_index() == 0
