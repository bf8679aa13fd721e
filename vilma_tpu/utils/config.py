"""Global numeric configuration for vilma_tpu.

The reference implementation is float64 throughout with a hard clamp at
EPSILON=1e-100 (reference numerics.py:8). float64 is what the parity tests
use, but the fast path computes in f32/bf16, so every epsilon in this
codebase is dtype-dependent: 1e-100 underflows to 0 in f32, which would
defeat its purpose of avoiding log(0)/division-by-zero.
"""
import numpy as np


#: Clamp used for probabilities / divisors, matching reference semantics
#: (numerics.py:8) in f64 and scaled to a representable value in f32.
_EPS_BY_DTYPE = {
    np.dtype(np.float64): 1e-100,
    np.dtype(np.float32): 1e-30,
}


def epsilon(dtype):
    """Return the numerical fudge factor appropriate for `dtype`."""
    return _EPS_BY_DTYPE[np.dtype(dtype)]


def default_dtype():
    """float64 when JAX x64 is enabled (CPU parity path), else float32."""
    import jax
    return np.float64 if jax.config.jax_enable_x64 else np.float32


def enable_x64():
    """Enable 64-bit mode in JAX. Call before any JAX computation."""
    import jax
    jax.config.update('jax_enable_x64', True)
