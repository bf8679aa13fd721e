"""The compact objective's XLA routes against brute force.

engine._objective_compact evaluates the mixture components ("the
prologue": closed-form component moments, the stabilized categorical
vi_delta, posterior moments, beta KL) either by staging whole [K, I]
CompactExprs or, for grids past the chunking budget, K-chunk by K-chunk
with the online-softmax identity (engine._chunked_moments). Both are
pinned here against a float64 numpy reference that materializes every
per-SNP, per-component covariance ([K, P, I]), and against each other,
including under the shard-local mesh.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vilma_tpu.inference import engine
from vilma_tpu.ops import blocks, kernels, lowrank
from vilma_tpu.parallel import alignment, mesh as mesh_mod
from vilma_tpu.utils import synthetic


def _bruteforce(data, nat, hyper, error_scaling):
    """(post_means, post_vars, vi_delta [K, I]) by explicit per-SNP PxP
    inverses in float64 (reference variational_inference.py:452-490,
    632-641, 712-733)."""
    prec = np.asarray(data.mixture_prec, np.float64)           # [K, P, P]
    log_det = np.asarray(data.log_det, np.float64)             # [K]
    dterm = (np.asarray(data.scaled_ld_diags, np.float64)
             / np.asarray(error_scaling, np.float64)[:, None])  # [P, I]
    ann = np.asarray(data.annotations)
    K, P = prec.shape[:2]
    I = dterm.shape[1]
    nat = np.asarray(nat, np.float64)
    if nat.ndim == 2:
        nat = np.broadcast_to(nat[None], (K, P, I))
    prec_ki = prec[:, None] + np.eye(P)[None, None] * dterm.T[None, :, None]
    sig = np.linalg.inv(prec_ki)                               # [K,I,P,P]
    mu = np.einsum('kipq,kqi->kpi', sig, nat)
    logdet_sig = np.linalg.slogdet(sig)[1]                     # [K, I]
    quad = np.einsum('kpi,kpi->ki', nat, mu)
    logh = np.log(np.asarray(hyper, np.float64))               # [A, K]
    rows = np.minimum(ann, logh.shape[0] - 1)
    logit = (logh[rows].T - 0.5 * log_det[:, None]
             + 0.5 * (logdet_sig + quad))
    logit -= logit.max(axis=0, keepdims=True)
    delta = np.exp(logit)
    delta /= delta.sum(axis=0, keepdims=True)
    diag = np.einsum('kipp->kpi', sig)
    pm = np.einsum('kpi,ki->pi', mu, delta)
    pv = np.einsum('kpi,ki->pi', diag + mu ** 2, delta) - pm ** 2
    return pm, pv, delta


def _point(num_pops, num_annotations, kdim, seed=1):
    data = synthetic.synthetic_problem(num_loci=300, num_pops=num_pops,
                                       num_components=5, block_size=32,
                                       num_annotations=num_annotations,
                                       scale_se=kdim)
    st = synthetic.synthetic_state(data, seed=seed, compact=True)
    assert st.nat_mu.ndim == (3 if kdim else 2)
    rng = np.random.default_rng(seed)
    K = data.mixture_prec.shape[0]
    hyper = rng.uniform(0.1, 1.0, (num_annotations, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    st = dataclasses.replace(
        st, hyper_delta=jnp.asarray(hyper),
        nat_mu=st.nat_mu + 1e-2 * rng.standard_normal(st.nat_mu.shape),
        error_scaling=jnp.asarray(rng.uniform(0.8, 1.2, num_pops)))
    return data, st


def _dense_linked(data, pm):
    dense = blocks.to_dense(data.ld[0])
    return (dense @ (np.asarray(pm) / np.asarray(data.std_errs)).T).T


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 12])
@pytest.mark.parametrize('kdim', [False, True])
def test_staged_objective_matches_bruteforce(num_pops, num_annotations,
                                             kdim):
    """The staged route's posterior means and LD-linked estimates match
    the float64 brute force, and its objective matches the ELBO of the
    materialized state (an independent staging of the same terms). kdim
    runs the per-component [K, P, I] scale_se natural mean."""
    data, st = _point(num_pops, num_annotations, kdim)
    obj, pm, linked = engine._objective_compact(data, st, st.nat_mu,
                                                st.hyper_delta)
    pm_b, _, _ = _bruteforce(data, st.nat_mu, st.hyper_delta,
                             st.error_scaling)
    scale = np.abs(pm_b).max()
    assert np.allclose(np.asarray(pm), pm_b, rtol=1e-9, atol=1e-12 * scale)
    lk_b = _dense_linked(data, pm_b)
    assert np.allclose(np.asarray(linked), lk_b, rtol=1e-9,
                       atol=1e-12 * np.abs(lk_b).max())
    mat = engine.materialize_state(data, st)
    want = engine.elbo_jit(data, mat.sigma, mat.error_scaling, mat.vi_mu,
                           mat.vi_delta, mat.hyper_delta)
    assert np.isclose(float(obj), float(want), rtol=1e-10)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 12])
def test_chunked_moments_match_bruteforce(num_pops, num_annotations,
                                          monkeypatch):
    """The K-chunked route (chunk width 2, so several chunks and a padded
    last one) gives the brute-force posterior moments and the staged
    route's objective."""
    data, st = _point(num_pops, num_annotations, kdim=False, seed=2)
    obj_s, _, _ = engine._objective_compact(data, st, st.nat_mu,
                                            st.hyper_delta)
    monkeypatch.setattr(engine, '_chunk_kc', lambda *a: 2)
    pm, pv, _, _, _ = engine._chunked_moments(data, st, st.nat_mu,
                                              st.hyper_delta)
    pm_b, pv_b, _ = _bruteforce(data, st.nat_mu, st.hyper_delta,
                                st.error_scaling)
    assert np.allclose(np.asarray(pm), pm_b, rtol=1e-9,
                       atol=1e-12 * np.abs(pm_b).max())
    assert np.allclose(np.asarray(pv), pv_b, rtol=1e-8,
                       atol=1e-12 * np.abs(pv_b).max())
    obj_c, _, _ = engine._objective_chunked(data, st, st.nat_mu,
                                            st.hyper_delta)
    assert np.isclose(float(obj_c), float(obj_s), rtol=1e-10)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('kdim', [False, True])
def test_sum_annotations_matches_bruteforce(num_pops, kdim, monkeypatch):
    """The hyper-delta update's annotation sums of the derived vi_delta
    (kernels.sum_annotations; engine._delta_sums_chunked for the shared
    natural mean) equal brute-force segment sums."""
    data, st = _point(num_pops, 3, kdim, seed=3)
    _, _, delta_b = _bruteforce(data, st.nat_mu, st.hyper_delta,
                                st.error_scaling)
    ann = np.asarray(data.annotations)
    want = np.stack([delta_b[:, ann == a].sum(axis=1) for a in range(3)])
    _, _, vi_delta = engine._derive_params(data, st.error_scaling,
                                           st.nat_mu, st.hyper_delta)
    got = np.asarray(kernels.sum_annotations(vi_delta, data.annotations,
                                             data.num_annotations))
    assert np.allclose(got, want, rtol=1e-9, atol=1e-12)
    if not kdim:
        monkeypatch.setattr(engine, '_chunk_kc', lambda *a: 2)
        got_c = np.asarray(engine._delta_sums_chunked(
            data, st, st.nat_mu, st.hyper_delta))
        assert np.allclose(got_c, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('num_pops', [2, 3])
def test_sharded_chunked_step_matches_single_device(num_pops, monkeypatch):
    """Under the shard-local mesh layout the K-chunked route runs on
    span-sharded [P, I] operands (its K-reductions are per SNP, the
    objective's sums psum'd by SPMD); one outer step reproduces the
    single-device step on the real slots and keeps pad slots inert."""
    monkeypatch.setattr(engine, '_chunk_kc', lambda *a: 2)
    monkeypatch.setattr(engine, '_use_chunked',
                        lambda data, nat: nat.ndim == 2)
    engine.outer_step.clear_cache()
    num_loci = 520
    rng = np.random.default_rng(11)
    factors, indices = [], []
    for a, b in [(0, 96), (96, 256), (256, 400), (400, 520)]:
        m = rng.standard_normal((b - a, b - a))
        factors.append(lowrank.factor_block(
            X=m @ m.T + (b - a) * np.eye(b - a), t=1.0,
            check_symmetric=False))
        indices.append(np.arange(a, b))
    ld = blocks.pack(factors, indices, num_loci)
    std_errs = rng.uniform(0.01, 0.05, (num_pops, num_loci))
    betas = rng.standard_normal((num_pops, num_loci)) * std_errs * 2
    covs = [np.eye(num_pops) * s for s in (1e-6, 1e-4, 1e-3, 1e-2, 1e-1)]
    annotations = np.zeros((num_loci, 2))
    annotations[np.arange(num_loci), rng.integers(0, 2, num_loci)] = 1

    def build(ld_mats, b, se, annot):
        return engine.build_model_data(
            b, se, ld_mats, annot, covs, scaled=False, scale_se=False,
            gwas_N=np.full(num_pops, 1e5), init_hg=np.full(num_pops, 0.3))

    try:
        data1 = build([ld] * num_pops, betas, std_errs, annotations)
        state1 = synthetic.synthetic_state(data1, compact=True)
        st1, pm1 = engine.outer_step(data1, state1, line_search_rate=2.0)

        lmap, L, ok = alignment.compute_layout([ld], num_loci, n_shards=8)
        assert ok
        lds = alignment.relayout_ld(ld, lmap, L, n_shards=8)
        assert lds.shard_count == 8
        mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
        with jax.set_mesh(mesh):
            data2 = build(
                [lds] * num_pops,
                alignment.relayout_rows(betas, lmap, L, fill=0.0),
                alignment.relayout_rows(std_errs, lmap, L, fill=1.0),
                alignment.relayout_annotations(annotations, lmap, L))
            state2 = synthetic.synthetic_state(data2, compact=True)
        state2 = dataclasses.replace(
            state2,
            nat_mu=jnp.zeros_like(state2.nat_mu).at[..., lmap].set(
                state1.nat_mu),
            hyper_delta=state1.hyper_delta, L=state1.L,
            error_scaling=state1.error_scaling, elbo=state1.elbo,
            running_elbo_delta=state1.running_elbo_delta)
        sdata = mesh_mod.shard_data(data2, mesh)
        sstate = mesh_mod.shard_state(state2, mesh)
        with jax.set_mesh(mesh):
            st2, pm2 = engine.outer_step(sdata, sstate,
                                         line_search_rate=2.0)
    finally:
        engine.outer_step.clear_cache()

    assert np.allclose(np.asarray(pm2)[:, lmap], np.asarray(pm1),
                       rtol=1e-9, atol=1e-11)
    pads = np.setdiff1d(np.arange(L), lmap)
    assert np.all(np.asarray(pm2)[:, pads] == 0)
    assert np.isclose(float(st2.elbo), float(st1.elbo), rtol=1e-10)
