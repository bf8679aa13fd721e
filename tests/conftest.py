"""Test configuration.

By default the tests run on the CPU backend, with a simulated 8-device
mesh for the collectives/sharding tests (SURVEY.md section 4) and x64
for the float64 parity tests:

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'

Tests that need an NVIDIA GPU carry the `gpu` marker and skip elsewhere
(the `gpu` fixture decides, at run time). On a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

A GPU run keeps x64 off, as `fit --precision f32` does.
"""
import os

import pytest

# CLI tests spawn subprocesses that inherit os.environ, so an unset
# platform is pinned to the CPU here for them too
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

if os.environ['JAX_PLATFORMS'] == 'cpu':
    jax.config.update('jax_enable_x64', True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU: run JAX_PLATFORMS=cuda,cpu '
                    'python -m pytest -m gpu tests/')
