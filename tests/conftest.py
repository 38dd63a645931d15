"""Test env: force CPU with a virtual 8-device mesh so sharding tests run
anywhere; the fused kernels run in interpret mode. The GPU paths are
exercised by chip_smoke.py on the card (tests that need a card carry the
`hardware` marker and skip here).

XLA_FLAGS must be set before the CPU backend initializes. JAX_PLATFORMS
defaults to the CPU; on a GPU machine `JAX_PLATFORMS=cuda,cpu python -m
pytest tests -m hardware` runs the GPU tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

import numpy as np
import pytest


def pytest_collection_modifyitems(config, items):
    """`hardware` and `mesh_subprocess` imply `slow`, so the fast tier is
    exactly one expression: pytest -m "not slow"; the full gate is a plain
    `pytest tests/`."""
    slow = pytest.mark.slow
    for item in items:
        if "hardware" in item.keywords or "mesh_subprocess" in item.keywords:
            item.add_marker(slow)


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first NVIDIA GPU JAX sees; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU")
