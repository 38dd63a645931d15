"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

from __future__ import annotations

import os

from mppi_gpu_tpu.utils import compile_cache as cc

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.cache_dir() == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)
    assert cc.cache_dir("/elsewhere") == str(tmp_path)


def test_environment_variable_means_nothing_is_set(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_explicit_directory_without_the_variable(monkeypatch, tmp_path):
    import jax

    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache(str(tmp_path / "c"))
        assert path == str(tmp_path / "c") and os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
