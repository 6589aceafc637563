"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else the
fixed ``.jax_cache`` of the checkout."""

import os

import jax
import pytest

from pathtracerap.utils.profiling import enable_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    path = enable_compile_cache()
    assert path == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path
