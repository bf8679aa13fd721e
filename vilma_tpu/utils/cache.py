"""JAX's persistent compilation cache, kept at one fixed path.

A compiled program is found again only when the cache directory does not
move, so the path is fixed: the directory JAX_COMPILATION_CACHE_DIR names
when it is set (JAX reads that variable itself), otherwise `.jax_cache/`
at the root of this checkout.
"""
import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def configure_compile_cache():
    """Point JAX's compilation cache at its fixed directory; returns it."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', CHECKOUT_CACHE)
    return CHECKOUT_CACHE
