"""The fused kernels compiled for the card (no interpret mode). These need an
NVIDIA GPU and skip without one; chip_smoke.py runs the same checks at full
width. Run them on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m hardware
"""

from __future__ import annotations

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.hardware
def test_family_kernels_match_reference_on_gpu(gpu):
    import chip_smoke

    with jax.default_device(gpu):
        chip_smoke.phase_kernels(Ks=(4096, 8192), T=50, fleet_R=2)


@pytest.mark.hardware
def test_controllers_run_on_gpu(gpu):
    import chip_smoke

    with jax.default_device(gpu):
        chip_smoke.phase_full(K_small=4096, K_big=65_536, fleet_K=4096, T=50)
