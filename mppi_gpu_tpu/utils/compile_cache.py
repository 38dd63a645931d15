"""Persistent XLA compilation cache placement, shared by the CLI, bench.py
and chip_smoke.py.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at one fixed directory inside
the checkout (``.jax_cache/``, listed in ``.gitignore``): a fixed path, so
that a later process finds what an earlier one compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir(requested: str | None = None) -> str:
    """The directory the cache uses: the environment variable when set, else
    `requested`, else the in-checkout default."""
    return os.environ.get(ENV_VAR) or requested or DEFAULT_DIR


def enable_compile_cache(requested: str | None = None) -> str:
    """Turn the persistent cache on (before the first compile) and return its
    directory."""
    path = cache_dir(requested)
    if ENV_VAR in os.environ and os.environ[ENV_VAR]:
        return path
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
