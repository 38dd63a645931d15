"""The fused kernels' block plan (padding, masking, grid) and the `auto`
backend resolution per family — pure Python, no kernel runs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from fused_check import FAMILY_CONFIGS, family_problem
from mppi_gpu_tpu.ops import fused_rollout as fr


@pytest.mark.parametrize("A", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("K", [2, 8, 100, 256, 1000, 4096, 10_000])
def test_plan_geometry_invariants(A, K):
    plan = fr.make_plan(K, 50, A, antithetic=K % 2 == 0)
    b = plan.block
    assert b & (b - 1) == 0 and fr.BLOCK_MIN <= b <= fr.BLOCK_MAX
    assert plan.n_blocks * b == plan.Kpad
    assert K <= plan.Kpad < K + b          # padding below one block
    assert plan.num_warps * 32 == b        # one rollout per thread
    assert plan.A == A and plan.R == 1


@pytest.mark.parametrize("K,R,block", [
    (1, 1, 32), (3000, 1, 32), (10_000, 1, 64), (100_000, 1, 256),
    (1_000_000, 1, 256), (3000, 8, 128), (100_000, 8, 256),
])
def test_block_grows_with_total_rollouts(K, R, block):
    """Small K spreads over the SMs in small blocks; large K or a fleet gets
    the largest block."""
    assert fr.pick_block(K, R) == block


def test_antithetic_needs_even_K():
    with pytest.raises(ValueError, match="even K"):
        fr.make_plan(7, 5, 2, antithetic=True)


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"), ("cpu", "scan")])
@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_auto_backend_per_family(family, platform, want):
    from mppi_gpu_tpu.controller import resolve_backend

    dyn, cost, _, _ = family_problem(family)
    assert resolve_backend("auto", dyn, cost, platform=platform) == want
    assert resolve_backend("scan", dyn, cost, platform=platform) == "scan"


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_backend_sends_learned_dynamics_to_scan(platform):
    from mppi_gpu_tpu.controller import resolve_backend
    from mppi_gpu_tpu.models.neural import init_mlp_dynamics

    mlp = init_mlp_dynamics(jax.random.key(0), 6, 3)
    cost = family_problem("lti")[1]
    assert resolve_backend("auto", mlp, cost, platform=platform) == "scan"


def test_controller_resolves_against_default_backend():
    """Here the default backend is the CPU: `auto` must pick scan."""
    from mppi_gpu_tpu.config import load_config
    from mppi_gpu_tpu.controller import MPPIController

    ctrl = MPPIController(load_config("configs/point_mass2d.yaml"))
    assert ctrl.rollout_backend == "scan"


def test_obstacle_count_is_static_in_the_plan():
    dyn, cost, _, _ = family_problem("lti-obstacle")
    plan = fr.plan_for(dyn, cost, 100, 10, 2)
    assert plan.family == "lti-obstacle" and plan.extra == 2
    rows = fr.pack_rows(dyn, cost, jnp.zeros((1, 4)), jnp.ones(2), plan)
    # dt, σ (2), λ·Σ⁻¹ (2), lti (6·2), penalty, 2 × (center (2), r²)
    assert rows.shape == (1, 1 + 2 + 2 + 12 + 1 + 2 * 3)
