"""Where the persistent compilation cache goes."""

import os

import pytest

from soap3dp_tpu.utils import jaxcache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ("/some/dir", None),                         # JAX reads the variable
    (None, os.path.join(CHECKOUT, ".jaxcache")),  # fixed checkout path
])
def test_cache_dir(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert jaxcache.cache_dir() == want


def test_env_cache_dir_is_left_to_jax(monkeypatch):
    """With the variable set, enabling the cache sets no directory."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    monkeypatch.setattr(jaxcache, "_enabled", False)
    set_dirs = []
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: (
        set_dirs.append(v) if k == "jax_compilation_cache_dir"
        else real_update(k, v)))
    jaxcache.enable_persistent_cache()
    assert set_dirs == []
