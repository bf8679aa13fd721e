"""f32 fast-path accuracy: the f32 precision mode must reproduce the f64
parity path within statistical tolerance (posterior SDs are ~SE-scale;
f32 noise must stay well below them)."""
import numpy as np

from vilma_tpu.inference import engine
from vilma_tpu.utils import synthetic


def _fit(dtype):
    data = synthetic.synthetic_problem(num_loci=2048, num_pops=2,
                                       num_components=6, block_size=256,
                                       num_annotations=2, dtype=dtype,
                                       scale_se=True)
    state = synthetic.synthetic_state(data)
    for _ in range(25):
        state, pm = engine.outer_step(data, state, line_search_rate=2.0)
    post = np.asarray(engine.posterior_mean(state.vi_mu, state.vi_delta))
    return post, float(state.elbo), np.asarray(state.error_scaling)


def test_f32_matches_f64():
    post64, elbo64, esc64 = _fit(np.float64)
    post32, elbo32, esc32 = _fit(np.float32)
    scale = np.abs(post64).max()
    assert np.allclose(post32, post64, atol=2e-3 * scale + 1e-7)
    assert np.allclose(esc32, esc64, rtol=1e-3)
    assert np.isclose(elbo32, elbo64, rtol=1e-4)


def test_floor_mixture_covs_rejects_negative_definite():
    """A matrix with an EVEN number of negative eigenvalues passes the
    slogdet-sign gate (det(diag(-1,-1)) = 1 > 0, same hole as the
    reference's check), so the f32 flooring must reject it rather than
    silently repairing it into a different (valid) model."""
    import pytest
    covs = np.stack([np.diag([-1.0, -1.0]),
                     np.array([[1.0, 0.3], [0.3, 1.0]])])
    with pytest.raises(ValueError, match='positive definite'):
        engine._floor_mixture_covs(covs)
    # tiny eigh round-off on a true PSD matrix must still be floored,
    # not rejected
    v = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)
    psd = np.stack([v @ np.diag([1.0, -1e-16]) @ v.T])
    floored = engine._floor_mixture_covs(psd)
    assert np.linalg.eigvalsh(floored).min() > 0


def test_floor_mixture_covs_rescues_subnormal_spike():
    """The reference grid's near-zero spike can land below f32's
    smallest normal (a real fixture produced 6.6e-44 variance), which
    used to cast mixture_prec to inf and NaN the whole f32 fit."""
    covs = np.stack([np.eye(2) * 1e-44, np.eye(2) * 1e-3,
                     np.array([[1.0, 0.3], [0.3, 1.0]])])
    floored = engine._floor_mixture_covs(covs)
    prec32 = np.linalg.inv(floored).astype(np.float32)
    assert np.all(np.isfinite(prec32))
    # sane components are untouched
    assert np.allclose(floored[1:], covs[1:])
    # and the spike stays a spike: far below the real components
    assert floored[0][0, 0] < 1e-8


def test_f32_fit_survives_subnormal_spike_grid():
    """End-to-end: an f32 fit whose grid includes a sub-f32 spike must
    produce finite outputs that track the f64 fit."""
    outs = {}
    for dtype in (np.float64, np.float32):
        np.random.seed(11)
        data = synthetic.synthetic_problem(
            num_loci=128, num_pops=1, num_components=3, block_size=32,
            dtype=dtype)
        # overwrite the covariances with a grid containing the
        # pathological spike (rebuild model data to apply the floor)
        covs = np.stack([np.eye(1) * 1e-44, np.eye(1) * 1e-4,
                         np.eye(1) * 1e-2])
        data = engine.build_model_data(
            np.asarray(data.marginal_effects),
            np.asarray(data.std_errs), list(data.ld),
            np.eye(1)[np.zeros(128, dtype=int)], covs, scaled=False,
            scale_se=False, gwas_N=np.full(1, 1e5),
            init_hg=np.full(1, 0.3), dtype=dtype)
        st = synthetic.synthetic_state(data)
        for _ in range(5):
            st, pm = engine.outer_step(data, st, line_search_rate=2.0)
        outs[np.dtype(dtype).name] = np.asarray(pm)
        assert np.all(np.isfinite(np.asarray(pm))), dtype
    scale = np.abs(outs['float64']).max()
    assert np.max(np.abs(outs['float32'] - outs['float64'])) < 2e-3 * scale


def test_optimize_raises_on_nan_state(monkeypatch):
    """The secondary NaN guard: a fit that degenerates to NaN must raise
    'Encountered a numerical error', never write NaN outputs (the
    f32/bf16 line-search guard runs with a loosened rtol and cannot
    catch this by itself)."""
    import dataclasses
    import pytest
    np.random.seed(12)
    data = synthetic.synthetic_problem(num_loci=64, num_pops=1,
                                       num_components=2, block_size=16,
                                       dtype=np.float32)
    scheme = engine.MultiPopVI(
        marginal_effects=np.asarray(data.marginal_effects),
        std_errs=np.asarray(data.std_errs), ld_mats=list(data.ld),
        mixture_covs=np.linalg.inv(np.asarray(data.mixture_prec)),
        annotations=np.ones((64, 1)), checkpoint=False,
        checkpoint_freq=-1, output='/tmp/vilma_tpu_nan_guard',
        scaled=False, scale_se=False, gwas_N=np.full(1, 1e5),
        init_hg=np.full(1, 0.3), num_its=5, dtype=np.float32)

    real_step = engine.outer_step_donated

    def poisoned(data, st, line_search_rate):
        st, pm = real_step(data, st, line_search_rate=line_search_rate)
        return (dataclasses.replace(
            st, elbo=st.elbo * np.float32(np.nan)), pm)

    monkeypatch.setattr(engine, 'outer_step_donated', poisoned)
    with pytest.raises(RuntimeError, match='numerical error'):
        scheme.optimize()
