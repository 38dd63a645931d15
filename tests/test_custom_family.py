"""Public fused-family extension API (register_family): an OUT-OF-TREE family
— examples/custom_family.py's kinematic bicycle, no package edits — must ride
every piece of shared kernel machinery and match the scan reference fed the
same ε, the verification the built-in families get (test_unicycle.py
pattern, itself the analog of the reference's CPU-oracle kernel tests,
reference src/test.cu:97-105)."""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_example():
    import sys

    path = os.path.join(ROOT, "examples", "custom_family.py")
    spec = importlib.util.spec_from_file_location("custom_family", path)
    mod = importlib.util.module_from_spec(spec)
    # dataclass creation resolves string annotations through
    # sys.modules[cls.__module__] — register before exec
    sys.modules["custom_family"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _load_example()


def test_registration_validates_protocol():
    from mppi_gpu_tpu import register_family
    from mppi_gpu_tpu.ops.fused_rollout import unregister_family

    class MissingBits:
        name = "broken"

    with pytest.raises(TypeError, match="lacks required attribute"):
        register_family(MissingBits)

    class NoName:
        name = ""
        supports = staticmethod(lambda d, c: False)
        pack_planar = staticmethod(lambda *a: None)
        build_planar = staticmethod(lambda *a: None)

    with pytest.raises(TypeError, match="non-empty"):
        register_family(NoName)

    class StealsBuiltin(NoName):
        name = "lti"

    with pytest.raises(ValueError, match="built-in"):
        register_family(StealsBuiltin)
    with pytest.raises(ValueError, match="built-in"):
        unregister_family("lti")


def test_reregistration_replaces_user_family(example):
    """Module re-import (a new class object, same name) must not error —
    the example module is loaded twice across this test session."""
    from mppi_gpu_tpu.ops.fused_rollout import FAMILIES

    again = _load_example()
    assert FAMILIES["bicycle-demo"] is again.BicycleFamily
    assert again.BicycleFamily is not example.BicycleFamily
    # restore the module-fixture's class (its isinstance checks must keep
    # matching the fixture's instances in the remaining tests)
    from mppi_gpu_tpu import register_family

    register_family(example.BicycleFamily)


def _setup(example, T=11, K=260):
    dyn = example.BicycleDynamics.create(0.05)
    cost = example.BicycleWaypointCost(
        w=jnp.asarray([2.0, 0.3]), goal=jnp.asarray([3.0, 1.5]),
        v_ref=jnp.float32(0.8), lambda_=jnp.float32(0.4),
        inv_s=jnp.asarray([1.0, 0.7]),
    )
    x0 = jnp.asarray([0.1, -0.2, 0.3, 0.5])
    t = jnp.arange(T, dtype=jnp.float32)
    U = jnp.stack([0.5 + 0.3 * jnp.sin(0.3 * t), 0.2 * jnp.cos(0.5 * t)], axis=1)
    sigma = jnp.asarray([0.8, 0.5])
    return dyn, cost, x0, U, sigma


def test_dispatch_selects_registered_family(example):
    from mppi_gpu_tpu.controller import resolve_backend
    from mppi_gpu_tpu.ops import fused_rollout as fr

    dyn, cost, *_ = _setup(example)
    assert fr.family_for(dyn, cost) == "bicycle-demo"
    assert resolve_backend("auto", dyn, cost, platform="gpu") == "pallas"
    assert resolve_backend("auto", dyn, cost, platform="cpu") == "scan"


def test_custom_family_matches_oracle(example):
    """Kernels A/B vs the scan reference fed the same ε (interpreted) — the
    verification pattern an out-of-tree family author follows."""
    from fused_check import check_against_reference

    for anti, ou in ((False, 0.0), (True, 0.0), (False, 0.5)):
        dyn, cost, x0, U, sigma = _setup(example, 11, 260)
        check_against_reference(dyn, cost, x0, U, sigma, K=260, antithetic=anti,
                                ou_beta=ou, key=jax.random.key(7), lam=0.6)


def test_controller_end_to_end_interpret(example):
    """MPPIController drives the registered family through the REAL fused
    dispatch path (pallas-interpret) and through scan: both reach the
    waypoint."""
    ctrl, dyn = example.make_controller(
        samples=256, horizon=24, backend="pallas-interpret"
    )
    ctrl_scan, _ = example.make_controller(samples=256, horizon=24, backend="scan")
    assert ctrl.rollout_backend == "pallas-interpret"
    for c in (ctrl, ctrl_scan):
        x = jnp.asarray([0.0, 0.0, 0.0, 0.0])
        U = c.init_action_seq()
        key = c.init_key()
        for step in range(70):
            res = c.solve_auto(x, U, key, step)
            x, U = dyn.step(x, res.action), res.u_next
        d = float(jnp.hypot(x[0] - 3.0, x[1] - 1.5))
        assert d < 0.5, f"{c.rollout_backend}: final {np.asarray(x)}, dist {d:.3f}"


def test_demo_smoke(example, capsys):
    rc = example.main(["--steps", "90", "--samples", "512", "--backend", "scan"])
    out = capsys.readouterr().out
    assert "backend resolved: scan" in out
    assert rc == 0
