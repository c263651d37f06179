"""Where the persistent compilation cache lives (utils/jaxcache.py)."""

import os

import jax

from vstrains_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_follows_env_var(monkeypatch, tmp_path):
    target = str(tmp_path / "xla_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert jaxcache.enable_persistent_cache() == target
        assert jax.config.jax_compilation_cache_dir == target
        assert os.path.isdir(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = jaxcache.cache_dir()
    assert first == jaxcache.cache_dir() == jaxcache.CHECKOUT_CACHE_DIR
    assert first == os.path.join(REPO, ".jax_cache")
    assert "~" not in first and ".cache" not in first.split(os.sep)
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
