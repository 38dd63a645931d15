"""chip_smoke.py's phases at toy size on the CPU (kernels interpreted, the
four-card phase on four of the virtual devices), and its refusal to run
without a GPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_to_run_without_a_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.phase_device(1)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_phase_at_toy_size():
    rows = chip_smoke.phase_kernels(Ks=(96, 128), T=6, fleet_R=2, interpret=True)
    assert rows.count("dU rel") == 2 * 8 + 2  # 8 families x 2 shapes + 2 robots


def test_cards_phase_on_four_virtual_devices():
    rows = chip_smoke.phase_cards(n=4, K=256, T=5, per_card=1,
                                  backend="pallas-interpret")
    assert "over 4 cards" in rows and "R=4" in rows
