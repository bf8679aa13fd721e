"""--precision auto resolution and what each precision configures.

auto follows the backend JAX runs on, decided in-process: f32 on a GPU,
f64 elsewhere. f64 runs on whatever backend that is (the GPU computes
float64 natively); f32 keeps JAX's matmul precision (a GPU may run f32
products in TF32 unless JAX_DEFAULT_MATMUL_PRECISION says otherwise)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest

from vilma_tpu.commands import fit as fit_mod

REF = os.environ.get('VILMA_REF', '/root/reference')
DATA = os.path.join(REF, 'tests', 'test_data')


def test_auto_resolves_f32_with_accelerator(monkeypatch):
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    assert fit_mod._resolve_precision('auto') == 'f32'


def test_auto_resolves_f64_without_accelerator(monkeypatch):
    monkeypatch.setattr(jax, 'default_backend', lambda: 'cpu')
    assert fit_mod._resolve_precision('auto') == 'f64'


def test_explicit_choices_pass_through(monkeypatch):
    # explicit --precision is never second-guessed (nor touches the
    # backend)
    def boom():
        raise AssertionError('backend must not be queried')
    monkeypatch.setattr(jax, 'default_backend', boom)
    assert fit_mod._resolve_precision('f32') == 'f32'
    assert fit_mod._resolve_precision('f64') == 'f64'


def test_probe_short_circuits_on_cpu_platforms(monkeypatch):
    # auto asks the backend in this process: no probe subprocess
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')

    def boom(*a, **k):
        raise AssertionError('no subprocess expected')
    monkeypatch.setattr(subprocess, 'run', boom)
    monkeypatch.setattr(subprocess, 'Popen', boom)
    assert fit_mod._resolve_precision('auto') == 'f64'


def test_configure_precision_keeps_the_backend():
    """f64 enables x64 without pinning a platform; f32 leaves JAX's
    default matmul precision alone."""
    platforms = jax.config.jax_platforms
    x64 = jax.config.jax_enable_x64
    matmul = jax.config.jax_default_matmul_precision
    try:
        fit_mod._configure_precision('f64')
        assert jax.config.jax_enable_x64
        assert jax.config.jax_platforms == platforms
        jax.config.update('jax_default_matmul_precision', None)
        fit_mod._configure_precision('f32')
        assert jax.config.jax_default_matmul_precision is None
        assert jax.config.jax_platforms == platforms
    finally:
        jax.config.update('jax_enable_x64', x64)
        jax.config.update('jax_default_matmul_precision', matmul)


def test_configure_precision_keeps_a_set_matmul_precision():
    """A matmul precision set before the fit (JAX_DEFAULT_MATMUL_PRECISION)
    is kept by the f32 path."""
    matmul = jax.config.jax_default_matmul_precision
    try:
        jax.config.update('jax_default_matmul_precision', 'highest')
        fit_mod._configure_precision('f32')
        assert jax.config.jax_default_matmul_precision == 'highest'
    finally:
        jax.config.update('jax_default_matmul_precision', matmul)


@pytest.mark.skipif(not os.path.isdir(DATA),
                    reason='reference fixtures unavailable')
def test_cli_default_precision_is_f64_on_cpu(tmp_path):
    """End-to-end: under a cpu-pinned environment the default (auto)
    resolves to the f64 parity path and the run still matches the
    reference golden."""
    out = str(tmp_path / 'vilma_run')
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['PYTHONPATH'] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep
        + env.get('PYTHONPATH', ''))
    log_path = str(tmp_path / 'fit.log')
    code = subprocess.call(
        [sys.executable, '-m', 'vilma_tpu.frontend', 'fit',
         '--logfile', log_path, '--verbose',
         '--ld-schema', os.path.join(DATA, 'ld_manifest.tsv'),
         '--sumstats', os.path.join(DATA, 'good_sumstats_beta.tsv'),
         '--output', out,
         '-K', '80', '--ldthresh', '0.8', '--init-hg', '0.2',
         '--samplesizes', '10e3', '--names', 'test_cohort',
         '--extract', os.path.join(DATA, 'good_variants.tsv'),
         '--num-its', '12'],
        env=env)
    assert code == 0
    with open(log_path) as fh:
        log = fh.read()
    assert 'Selected --precision f64' in log
    # the resolved-f64 run must produce float64 outputs
    est = pd.read_csv(out + '.estimates.tsv', sep='\t', header=0)
    assert np.isfinite(est['posterior_test_cohort']).all()
