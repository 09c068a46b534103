"""Persistent compile-cache placement (utils/compile_cache.py)."""

import os

import jax
import pytest

from surface_multigrid_code_tpu.utils.compile_cache import (
    ENV_VAR,
    default_cache_dir,
    enable_persistent_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


@pytest.fixture
def restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_from_environment(tmp_path, monkeypatch, restore_config):
    target = tmp_path / "cache"
    monkeypatch.setenv(ENV_VAR, str(target))
    assert enable_persistent_cache() == str(target)
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(target)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_config):
    monkeypatch.delenv(ENV_VAR, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert default_cache_dir() == want
    assert enable_persistent_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
