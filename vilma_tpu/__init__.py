"""vilma_tpu: a JAX/XLA framework for estimating variant
effect sizes and effect-size distributions from GWAS summary statistics.

Provides the same capabilities as the reference `vilma` package,
redesigned for accelerator execution: block-sharded LD tensors, a pure
jitted coordinate-ascent VI engine, and mesh-parallel execution via
jax.sharding.
"""

VERSION = '0.1.0'

from vilma_tpu import utils  # noqa: F401


def __getattr__(name):
    # Lazy sub-imports so that `import vilma_tpu` stays cheap and does not
    # pull in JAX unless needed (mirrors `vilma.load` access pattern,
    # reference frontend.py:4-12).
    if name in ('load', 'io'):
        from vilma_tpu import io as _io
        return _io.load if name == 'load' else _io
    if name == 'ops':
        from vilma_tpu import ops
        return ops
    if name == 'models':
        from vilma_tpu import models
        return models
    if name == 'inference':
        from vilma_tpu import inference
        return inference
    raise AttributeError(f'module vilma_tpu has no attribute {name}')
