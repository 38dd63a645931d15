"""Single-process dryrun of the multi-host bootstrap codepath.

Run as a SUBPROCESS (tests/test_multihost.py): `jax.distributed.initialize`
must happen before the JAX backend initializes, which the pytest process
has long since done. Exercises the exact call sequence a multi-process run
makes — init_multihost (explicit coordinator, process count and id) →
global_mesh → ShardedMPPIController → solve — with num_processes=1 on a
virtual 8-device CPU mesh.
"""

import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# pick a free port for the single-process coordinator
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]

from mppi_gpu_tpu.parallel import global_mesh, init_multihost, is_coordinator

pid, n_proc = init_multihost(
    coordinator_address=f"localhost:{port}", num_processes=1, process_id=0
)
assert (pid, n_proc) == (0, 1), (pid, n_proc)
assert is_coordinator()
# idempotent: a second call must not re-initialize
assert init_multihost() == (0, 1)

mesh = global_mesh()
n_dev = int(
    os.environ["XLA_FLAGS"].rsplit("xla_force_host_platform_device_count=", 1)[1].split()[0]
)
assert mesh.devices.size == n_dev, (mesh, n_dev)

import jax.numpy as jnp
import numpy as np

from mppi_gpu_tpu.config import MPPIConfig
from mppi_gpu_tpu.parallel import ShardedMPPIController

cfg = MPPIConfig(
    env="t", samples=64, state_dim=4, action_dim=2, horizon=10, dt=0.1,
    lambda_=1.0, noise=(0.25, 0.25), init_act=(0.0, 0.0), max_a=(1.0, 1.0),
    goal=(1.0, 1.0, 0.0, 0.0), cost_type="quadratic",
    cost_w=(1.0, 1.0, 0.5, 0.5),
)
ctrl = ShardedMPPIController(cfg, mesh=mesh)
res = ctrl.solve(jnp.zeros(4), ctrl.init_action_seq(), ctrl.init_key())
assert res.u_next.shape == (10, 2)
assert np.isfinite(np.asarray(res.action)).all()
np.testing.assert_allclose(float(res.info.weights.sum()), 1.0, rtol=1e-5)

# the CLI wiring on top of the same bootstrap (init_multihost is idempotent,
# so the CLI's no-arg call reuses this process's runtime)
from mppi_gpu_tpu.cli import main as cli_main

rc = cli_main([
    "-c", "configs/point_mass2d.yaml", "--multihost", "--max-steps", "3",
])
assert rc == 0, rc

print("MULTIHOST_OK")
