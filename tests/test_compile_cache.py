"""The persistent compilation cache stays at one fixed directory."""
import os

import jax

from vilma_tpu.utils import cache


def _restore(value):
    jax.config.update('jax_compilation_cache_dir', value)


def test_env_directory_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    try:
        assert cache.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        _restore(before)


def test_default_is_the_checkout_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    try:
        path = cache.configure_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(cache.__file__))))
        assert path == os.path.join(root, '.jax_cache')
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        _restore(before)
