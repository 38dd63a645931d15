"""Device-mesh construction.

MPPI's only parallel axis is the rollout batch K (the reference shards it over
CUDA threads on one GPU; src/point_mass.cu:265). Here K shards over a flat 1-D
mesh of devices — on GPUs joined all to all (NVLink), so the mesh follows the
algorithm alone — and the solve needs exactly three small all-reduces (pmin β,
psum η, psum ΔU), which XLA hands to NCCL.
"""

from __future__ import annotations

from typing import Sequence

import jax
from jax.sharding import Mesh

ROLLOUT_AXIS = "k"


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = ROLLOUT_AXIS,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all)."""
    devices = list(devices if devices is not None else jax.devices())
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return jax.make_mesh((n,), (axis_name,), devices=devices[:n])
