"""Config-parse regression — analog of the reference's verify_parse
(src/main.cu:686-725): hard asserts on every field of the test fixture."""

from pathlib import Path

import pytest

from mppi_gpu_tpu.config import ConfigError, MPPIConfig, load_config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def test_parse_test_fixture():
    cfg = load_config(CONFIGS / "mppi-config-test.yaml")
    assert cfg.samples == 3
    assert cfg.state_dim == 4
    assert cfg.action_dim == 2
    assert cfg.horizon == 12
    assert cfg.dt == pytest.approx(0.1)
    assert cfg.lambda_ == pytest.approx(1.5)
    assert cfg.noise == pytest.approx((0.24, 0.26))
    assert cfg.init_act == pytest.approx((0.1, 0.2))
    assert cfg.max_a == pytest.approx((1.2, 1.3))
    assert cfg.goal == pytest.approx((1.0, 2.0, 3.0, 4.0))
    assert cfg.cost_type == "quadratic"
    assert cfg.cost_w == pytest.approx((1.0, 2.0, 0.5, 0.75))
    assert cfg.clamp_action is True
    assert cfg.inv_sigma == "identity"


@pytest.mark.parametrize("name,a,s", [("point_mass1d", 1, 2), ("point_mass2d", 2, 4), ("point_mass3d", 3, 6)])
def test_parse_task_configs(name, a, s):
    cfg = load_config(CONFIGS / f"{name}.yaml")
    assert cfg.action_dim == a
    assert cfg.state_dim == s
    assert cfg.samples == 3000
    assert cfg.horizon == 50
    assert len(cfg.noise) == a and len(cfg.goal) == s and len(cfg.cost_w) == s


def test_parses_reference_yaml_format(tmp_path):
    """The reference's YAML files use an indented top-level mapping after
    '---'; our loader must accept that exact shape."""
    p = tmp_path / "ref_style.yaml"
    p.write_text(
        "---\n"
        "    action-dim: 1\n"
        "    cost:\n"
        "      type: quadratic\n"
        "      w:\n"
        "        - 1\n"
        "        - 5\n"
        "    dt: 0.1\n"
        "    env: ../envs/point_mass1d.xml\n"
        "    goal:\n"
        "      - 1\n"
        "      - 0\n"
        "    horizon: 50\n"
        "    init-act:\n"
        "      - 0.0\n"
        "    lambda: 1\n"
        "    max-a:\n"
        "      - 1\n"
        "    noise:\n"
        "      - 0.25\n"
        "    samples: 3000\n"
        "    state-dim: 2\n"
    )
    cfg = load_config(p)
    assert cfg.action_dim == 1 and cfg.samples == 3000 and cfg.horizon == 50


def test_missing_key_raises(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("samples: 10\nhorizon: 5\n")
    with pytest.raises(ConfigError, match="missing required"):
        load_config(p)


def test_dim_mismatch_raises():
    with pytest.raises(ConfigError, match="goal"):
        MPPIConfig(
            env="x", samples=2, state_dim=2, action_dim=1, horizon=3, dt=0.1,
            lambda_=1.0, noise=(0.1,), init_act=(0.0,), max_a=(1.0,),
            goal=(1.0, 0.0, 3.0),  # wrong length
            cost_type="quadratic", cost_w=(1.0, 1.0),
        )


def test_unknown_cost_type_raises():
    from mppi_gpu_tpu.ops.cost import make_cost

    cfg = MPPIConfig(
        env="x", samples=2, state_dim=2, action_dim=1, horizon=3, dt=0.1,
        lambda_=1.0, noise=(0.1,), init_act=(0.0,), max_a=(1.0,),
        goal=(1.0, 0.0), cost_type="nope", cost_w=(1.0, 1.0),
    )
    with pytest.raises(ValueError, match="unknown cost.type"):
        make_cost(cfg)


@pytest.mark.parametrize(
    "path", sorted(CONFIGS.glob("*.yaml")), ids=lambda p: p.stem
)
def test_mini_yaml_matches_pyyaml(path):
    """The fallback parser (used where PyYAML is not installed) reads every
    shipped config exactly as PyYAML does."""
    import yaml

    from mppi_gpu_tpu.config import _mini_yaml, config_from_mapping

    text = path.read_text()
    assert _mini_yaml(text) == yaml.safe_load(text)
    assert config_from_mapping(_mini_yaml(text)) == config_from_mapping(
        yaml.safe_load(text)
    )
