"""REAL multi-process cluster check: OS processes wired into ONE JAX
runtime by `jax.distributed.initialize` (explicit coordinator address,
process count and id). Cross-process collectives ride XLA:CPU's Gloo
transport.

Scenarios, each run as a group of SUBPROCESSES by tests/test_multihost.py
(and by `__graft_entry__.dryrun_multihost`):

* ``scan`` — 2 processes × 4 virtual CPU devices, global 8-device mesh, the
  sharded scan-backend solve: the three collectives (pmin β, psum η,
  psum ΔU) cross the process boundary.
* ``pallas`` — 2 processes × 1 virtual CPU device, global 2-device mesh,
  rollout_backend="pallas-interpret": the fused kernels per device
  (interpreted) with their pmin/psum combine crossing the processes.
  ``pallas-8`` runs the same program as 8 processes × 1 device.

With no argv, this script runs both default scenario groups; with one
argv it runs that scenario's group; with argv = (scenario, process_id,
num_processes, port) it IS one of the processes.

Each process:
  * brings up the distributed runtime via `init_multihost` (the production
    bootstrap wrapper), asserting its (process_index, process_count),
  * builds the GLOBAL mesh spanning all processes (`global_mesh`),
  * runs the sharded MPPI solve — the collectives now cross the process
    boundary,
  * independently reconstructs the per-device noise (fold_in by mesh
    position, identical on every process) and asserts its replicated
    action/u_next against the single-device deterministic oracle,
  * checks its ADDRESSABLE shards of the K-sharded diagnostics line up with
    the oracle's corresponding slice (each process holds only its part).

Prints MULTIPROC_OK[scenario][pid] per process; the parent requires every
process of every scenario and prints a summary MULTIPROC_OK line naming
the scenarios.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("scan", "pallas")


def _nproc_of(scenario: str) -> int:
    if scenario.startswith("pallas-"):
        return int(scenario.rsplit("-", 1)[1])
    return 2


def run_group(scenario: str) -> None:
    nproc = _nproc_of(scenario)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [
                sys.executable, os.path.abspath(__file__),
                scenario, str(pid), str(nproc), str(port),
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit(f"[{scenario}] process {pid} timed out")
        outs.append((pid, p.returncode, out, err))
    for pid, rc, out, err in outs:
        if rc != 0 or f"MULTIPROC_OK[{scenario}][{pid}]" not in out:
            raise SystemExit(
                f"[{scenario}] process {pid} rc={rc}\n"
                f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
            )


run_pair = run_group  # back-compat alias


def parent() -> None:
    for scenario in SCENARIOS:
        run_group(scenario)
    print(f"MULTIPROC_OK scenarios={','.join(SCENARIOS)}")


def child(scenario: str, pid: int, nproc: int, port: int) -> None:
    import re

    n_local = 1 if scenario.startswith("pallas") else 4
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "",
        os.environ.get("XLA_FLAGS", ""),
    ).strip()
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_local}"
    ).strip()
    import faulthandler

    # self-diagnosing watchdog: if anything livelocks, dump all stacks and
    # exit so the parent's failure carries the evidence
    faulthandler.dump_traceback_later(200, exit=True)

    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, REPO)
    from mppi_gpu_tpu.parallel import global_mesh, init_multihost, is_coordinator

    got = init_multihost(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert got == (pid, nproc), got
    assert is_coordinator() == (pid == 0)
    assert len(jax.local_devices()) == n_local
    assert len(jax.devices()) == n_local * nproc

    import jax.numpy as jnp
    import numpy as np

    from mppi_gpu_tpu.config import MPPIConfig
    from mppi_gpu_tpu.controller import mppi_solve_deterministic, sample_noise
    from mppi_gpu_tpu.parallel import ShardedMPPIController

    mesh = global_mesh()
    n = mesh.devices.size
    assert n == n_local * nproc, mesh

    if scenario.startswith("pallas"):
        from mppi_gpu_tpu.ops.noise import noise_tensor

        # the point_mass3d geometry (a=3)
        K, T, a = n * 96, 7, 3
        cfg = MPPIConfig(
            env="t", samples=K, state_dim=2 * a, action_dim=a, horizon=T,
            dt=0.1, lambda_=1.0, noise=(0.25,) * a, init_act=(0.0,) * a,
            max_a=(1.0,) * a, goal=(1.0,) * a + (0.0,) * a,
            cost_type="quadratic", cost_w=(1.0,) * a + (0.5,) * a,
        )
        ctrl = ShardedMPPIController(
            cfg, mesh=mesh, rollout_backend="pallas-interpret"
        )
        assert ctrl.rollout_backend == "pallas-interpret"
        x = jnp.asarray([0.3, -0.2, 0.1, 0.0, 0.05, -0.05], jnp.float32)
        U = 0.05 * jnp.ones((T, a), jnp.float32)
        key = jax.random.key(13)
        res = ctrl.solve(x, U, key)
        jax.block_until_ready(res)

        # the shared generator's stream per device, concatenated in mesh
        # order — identical on every process, so all build the SAME oracle
        k_loc = K // n
        sigma = jnp.asarray(cfg.noise, jnp.float32)
        eps = jnp.concatenate(
            [
                noise_tensor(jax.random.fold_in(key, d), T, k_loc, a, sigma)
                for d in range(n)
            ],
            axis=1,
        )  # (T, K, a)
        ref = mppi_solve_deterministic(
            ctrl.dynamics, ctrl.cost, x, U, eps, ctrl.lambda_, ctrl.max_a,
            clamp=cfg.clamp_action,
        )
        np.testing.assert_allclose(
            float(res.info.beta), float(ref.info.beta), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(jax.device_get(res.action)), np.asarray(ref.action),
            rtol=1e-4, atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(jax.device_get(res.u_next)), np.asarray(ref.u_next),
            rtol=1e-4, atol=1e-6,
        )
        np.testing.assert_allclose(float(res.info.weights.sum()), 1.0, rtol=1e-5)
        # this process holds ONE addressable shard (1 device): its K-slice
        ref_costs = np.asarray(ref.info.costs)
        shards = list(res.info.costs.addressable_shards)
        assert len(shards) == 1, shards
        lo = shards[0].index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(shards[0].data), ref_costs[lo:lo + k_loc], rtol=3e-5
        )
        print(f"MULTIPROC_OK[{scenario}][{pid}]", flush=True)
        return

    cfg = MPPIConfig(
        env="t", samples=64, state_dim=4, action_dim=2, horizon=10, dt=0.1,
        lambda_=1.0, noise=(0.25, 0.25), init_act=(0.0, 0.0), max_a=(1.0, 1.0),
        goal=(1.0, 1.0, 0.0, 0.0), cost_type="quadratic",
        cost_w=(1.0, 1.0, 0.5, 0.5),
    )
    ctrl = ShardedMPPIController(cfg, mesh=mesh, rollout_backend="scan")
    x = jnp.asarray([0.3, -0.2, 0.1, 0.0], jnp.float32)
    U = ctrl.init_action_seq()
    key = jax.random.key(7)
    res = ctrl.solve(x, U, key)

    # every host reconstructs the SAME oracle: per-device keys fold by mesh
    # position, so the concatenated noise is host-independent
    k_loc = cfg.samples // n
    sigma = jnp.asarray(cfg.noise, jnp.float32)
    eps = jnp.concatenate(
        [
            sample_noise(
                jax.random.fold_in(key, d), cfg.horizon, k_loc,
                cfg.action_dim, sigma,
            )
            for d in range(n)
        ],
        axis=1,
    )
    ref = mppi_solve_deterministic(
        ctrl.dynamics, ctrl.cost, x, U, eps, ctrl.lambda_, ctrl.max_a,
        clamp=cfg.clamp_action,
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(res.action)), np.asarray(ref.action),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(res.u_next)), np.asarray(ref.u_next),
        rtol=1e-4, atol=1e-6,
    )
    # K-sharded diagnostics: this process holds only its local shards —
    # check each against the oracle slice it should carry
    ref_costs = np.asarray(ref.info.costs)
    local = 0
    for shard in res.info.costs.addressable_shards:
        lo = shard.index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(shard.data), ref_costs[lo:lo + k_loc], rtol=1e-5
        )
        local += 1
    assert local == 4, local
    print(f"MULTIPROC_OK[{scenario}][{pid}]", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 1:
        parent()
    elif len(sys.argv) == 2:
        run_group(sys.argv[1])
        print(f"MULTIPROC_OK scenarios={sys.argv[1]}")
    else:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
