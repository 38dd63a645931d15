"""Multi-host bootstrap dryrun (see mppi_gpu_tpu/parallel/multihost.py).

The reference has nothing to compare against (single process, single GPU);
this guards the multi-process bring-up path.
"""

import os
import subprocess
import sys

import pytest


@pytest.mark.mesh_subprocess
def test_multihost_bootstrap_single_process():
    """init_multihost → global_mesh → ShardedMPPIController executes with
    num_processes=1 on a fresh interpreter (jax.distributed.initialize must
    precede backend init, so this cannot run in the pytest process)."""
    script = os.path.join(os.path.dirname(__file__), "_multihost_check.py")
    out = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=240,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    assert "MULTIHOST_OK" in out.stdout, (
        f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-3000:]}"
    )


@pytest.mark.mesh_subprocess
def test_multihost_two_real_processes():
    """A REAL 2-process cluster (coordinator + worker OS processes) in two
    scenarios: `scan` (4 virtual CPU devices each, global 8-device mesh,
    the sharded scan solve) and `pallas` (1 device each, global 2-device
    mesh, the fused kernels per device with pmin β / psum η / psum ΔU
    riding XLA:CPU's Gloo transport ACROSS the process boundary). BOTH
    processes of BOTH scenarios must independently match the single-device
    deterministic oracle (replicated action/u_next plus each process's
    addressable K-shards) — see tests/_multiproc_check.py."""
    script = os.path.join(os.path.dirname(__file__), "_multiproc_check.py")
    out = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    assert out.returncode == 0 and (
        "MULTIPROC_OK scenarios=scan,pallas" in out.stdout
    ), (
        f"rc={out.returncode}\nstdout:\n{out.stdout}\nstderr:\n{out.stderr[-3000:]}"
    )


@pytest.mark.mesh_subprocess
def test_multihost_pallas_composed_n8():
    """The fused-kernel sharded solve at n=8: eight OS processes x 1
    virtual CPU device each, global 8-device mesh, the pmin/psum combine
    crossing 7/8 of its partners over Gloo, every process independently
    matching the deterministic oracle."""
    script = os.path.join(os.path.dirname(__file__), "_multiproc_check.py")
    out = subprocess.run(
        [sys.executable, script, "pallas-8"], capture_output=True,
        text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    assert out.returncode == 0 and (
        "MULTIPROC_OK scenarios=pallas-8" in out.stdout
    ), (
        f"rc={out.returncode}\nstdout:\n{out.stdout}\nstderr:\n{out.stderr[-3000:]}"
    )
