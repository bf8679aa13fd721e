"""Trajectory-level parity against the reference engine run in-process.

The strongest equivalence evidence available: the reference's own
VIScheme/MultiPopVI (imported from /root/reference with a no-op numba
shim, see reference_oracle.py) is run side by side with this
engine on identical inputs and identical RNG streams, comparing
initialization, single coordinate-ascent steps, and full optimization.
"""
import os

import numpy as np
import pytest

from vilma_tpu.ops import blocks
from vilma_tpu.inference import engine

pytestmark = pytest.mark.skipif(
    not os.path.isdir('/root/reference/src'),
    reason='reference tree unavailable')


def _problem(num_annotations=1, scale_se=False, scaled=False, seed=0):
    rng = np.random.default_rng(seed)
    n = 40
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    ld_a = 0.6 ** idx
    ld_b = 0.3 ** idx
    betas = rng.standard_normal((2, n)) * 0.05
    std_errs = rng.uniform(0.02, 0.1, (2, n))
    mixture_covs = [np.eye(2) * 1e-4, np.eye(2) * 1e-2,
                    np.array([[1e-2, 5e-3], [5e-3, 1e-2]])]
    if num_annotations == 2:
        annotations = np.zeros((n, 2), dtype=int)
        annotations[: n // 2, 0] = 1
        annotations[n // 2:, 1] = 1
    else:
        annotations = np.ones((n, 1), dtype=int)
    gwas_n = np.array([50e3, 20e3])
    init_hg = np.array([0.2, 0.4])
    kwargs = dict(marginal_effects=betas, std_errs=std_errs,
                  mixture_covs=mixture_covs, annotations=annotations,
                  checkpoint=False, checkpoint_freq=-1,
                  scaled=scaled, scale_se=scale_se, gwas_N=gwas_n,
                  init_hg=init_hg, num_its=15)
    return (ld_a, ld_b), kwargs


def _build_pair(num_annotations=1, scale_se=False, scaled=False):
    from tests import reference_oracle
    vilma = reference_oracle.install()
    from vilma import matrix_structures as ref_ms
    from vilma.variational_inference import MultiPopVI as RefVI

    (ld_a, ld_b), kwargs = _problem(num_annotations, scale_se, scaled)
    ref_lds = [ref_ms.BlockDiagonalMatrix(
        [ref_ms.LowRankMatrix(X=m, t=1.0)]) for m in (ld_a, ld_b)]
    mine_lds = [blocks.from_dense_blocks([m], [np.arange(m.shape[0])],
                                         m.shape[0])
                for m in (ld_a, ld_b)]

    np.random.seed(7)
    ref = RefVI(ld_mats=ref_lds, output='/tmp/ref_oracle', **kwargs)
    mine = engine.MultiPopVI(ld_mats=mine_lds, output='/tmp/mine_oracle',
                             **kwargs)
    return ref, mine


def test_sufficient_statistics_match():
    ref, mine = _build_pair()
    assert np.allclose(ref.chi_stat, np.asarray(mine.data.chi_stat))
    assert np.allclose(ref.adj_marginal_effects,
                       np.asarray(mine.data.adj_marginal_effects))
    assert np.allclose(ref.ld_ranks, np.asarray(mine.data.ld_ranks))
    assert np.allclose(ref.inverse_betas,
                       np.asarray(mine.data.inverse_betas))
    assert np.allclose(ref.mixture_prec[..., 0],
                       np.asarray(mine.data.mixture_prec))
    assert np.allclose(ref.log_det, np.asarray(mine.data.log_det))
    # vi_sigma summaries (materialize: the compact state derives them)
    st = mine.state or mine._fresh_state()
    st = engine.materialize_state(mine.data, st)
    assert np.allclose(ref.vi_sigma_log_det,
                       np.asarray(st.sigma.log_det_sigma))


def test_initialization_matches():
    ref, mine = _build_pair()
    np.random.seed(123)
    mu_r, delta_r, hyper_r = ref._initialize()
    np.random.seed(123)
    st = engine.materialize_state(mine.data, mine._initialize())
    assert np.allclose(mu_r, np.asarray(st.vi_mu), atol=1e-10)
    assert np.allclose(delta_r, np.asarray(st.vi_delta).T, atol=1e-12)
    assert np.allclose(hyper_r, np.asarray(st.hyper_delta), atol=1e-12)
    # ELBO of the identical state matches
    ref_elbo = ref.elbo((mu_r, delta_r, hyper_r))
    my_elbo = float(engine.elbo_jit(mine.data, st.sigma, st.error_scaling,
                                    st.vi_mu, st.vi_delta, st.hyper_delta))
    assert np.isclose(ref_elbo, my_elbo, rtol=1e-10)


@pytest.mark.parametrize('num_annotations,scale_se,scaled', [
    (1, False, False),
    (2, True, False),
    (1, False, True),
])
def test_full_optimization_matches(num_annotations, scale_se, scaled):
    ref, mine = _build_pair(num_annotations, scale_se, scaled)
    np.random.seed(123)
    ref_params = ref.optimize()
    ref_mean = ref.real_posterior_mean(*ref_params)
    np.random.seed(123)
    st = mine.optimize()
    my_mean = mine.real_posterior_mean(st)
    assert np.allclose(ref_mean, my_mean, rtol=1e-6, atol=1e-10)
    assert np.allclose(ref_params[2], np.asarray(st.hyper_delta),
                       rtol=1e-6, atol=1e-10)
    assert np.allclose(ref.error_scaling, np.asarray(st.error_scaling),
                       rtol=1e-8)
    ref_elbo = ref.elbo(ref_params)
    my_elbo = mine.elbo_value(st)
    assert np.isclose(ref_elbo, my_elbo, rtol=1e-8)
