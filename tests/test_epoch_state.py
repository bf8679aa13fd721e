"""Epoch-history scale_se representation (sigma.compact_exprs_epochs).

The error-scaling EM's k-dependent re-basings telescope, so the kdim
[K, P, I] natural-mean state is equivalent to O(E) shared [P, I] epoch
vectors + the scaling history — the representation that makes the
production configuration (CLI mixture grid x --learn-scaling) feasible
at genome scale (the kdim state is ~26 GiB at 6M SNPs with 582
components). These tests pin:

 1. the closed-form epoch algebra against a dense numpy re-derivation;
 2. trajectory-level equality with the kdim compact path through real
    EM events (the representations must be the SAME fit);
 3. MultiPopVI epoch-mode selection, checkpoint keys, and resume;
 4. the K-chunked epoch route against the staged one;
 5. the epoch step under a shard-local mesh against single-device, on
    both routes.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vilma_tpu.inference import engine
from vilma_tpu.models import sigma as sigma_mod
from vilma_tpu.ops import blocks, lowrank
from vilma_tpu.utils import synthetic


def _epoch_state(data, u, hyper, B=24, seed=None):
    """A fresh epoch-history state with accumulator `u` and an empty
    (or, with seed, randomly filled) history of B slots."""
    dtype = data.marginal_effects.dtype
    P, I = u.shape
    hist = np.zeros((B, P, I), dtype=dtype)
    scale = np.ones((B, P), dtype=dtype)
    c = np.zeros(B, dtype=dtype)
    n = 0
    if seed is not None:
        rng = np.random.default_rng(seed)
        n = 3
        hist[:n] = rng.standard_normal((n, P, I)) * 1e-2
        scale[:n] = rng.uniform(0.7, 1.4, (n, P))
        c[:n] = rng.uniform(0.1, 1.0, n)
    return engine.VIState(
        vi_mu=None, vi_delta=None, nat_grad_vi_delta=None, sigma=None,
        nat_mu=jnp.asarray(u, dtype=dtype),
        nat_hist=jnp.asarray(hist),
        nat_hist_scale=jnp.asarray(scale),
        nat_hist_c=jnp.asarray(c),
        nat_hist_n=jnp.asarray(n, dtype=jnp.int32),
        hyper_delta=jnp.asarray(hyper, dtype=dtype),
        error_scaling=jnp.ones(P, dtype=dtype),
        L=jnp.ones(3, dtype=dtype),
        elbo=jnp.asarray(0., dtype=dtype),
        running_elbo_delta=jnp.asarray(np.nan, dtype=dtype),
        num_err=jnp.asarray(0, dtype=jnp.int32))


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_epoch_exprs_match_bruteforce(num_pops):
    """compact_exprs_epochs == dense per-(k,i) solves in numpy."""
    rng = np.random.default_rng(4)
    K, P, I, B = 4, num_pops, 37, 3
    prec = []
    for _ in range(K):
        a = rng.standard_normal((P, P))
        prec.append(a @ a.T + P * np.eye(P))
    prec = np.stack(prec)
    sld = rng.uniform(0.5, 2.0, (P, I))
    cur_scale = rng.uniform(0.8, 1.2, P)
    dterm = sld / cur_scale[:, None]
    u = rng.standard_normal((P, I))
    hist_v = rng.standard_normal((B, P, I))
    hist_scale = rng.uniform(0.7, 1.4, (B, P))
    hist_c = rng.uniform(0.0, 1.0, B)
    hist_dt = sld[None] / hist_scale[:, :, None]

    ex = sigma_mod.compact_exprs_epochs(
        jnp.asarray(prec), jnp.asarray(dterm), jnp.asarray(u),
        jnp.asarray(hist_v), jnp.asarray(hist_dt), jnp.asarray(hist_c))

    mu = np.zeros((K, P, I))
    quad = np.zeros((K, I))
    for k in range(K):
        for i in range(I):
            cur = np.linalg.inv(prec[k] + np.diag(dterm[:, i]))
            m = cur @ u[:, i]
            for e in range(B):
                se = np.linalg.inv(prec[k] + np.diag(hist_dt[e, :, i]))
                m = m + hist_c[e] * (se @ hist_v[e, :, i])
            mu[k, :, i] = m
            quad[k, i] = m @ (prec[k] + np.diag(dterm[:, i])) @ m
    assert np.allclose(np.asarray(ex.mu), mu, rtol=1e-9, atol=1e-12)
    assert np.allclose(np.asarray(ex.quad), quad, rtol=1e-9, atol=1e-12)
    # the current-scaling summaries agree with make_summaries
    s = sigma_mod.make_summaries(jnp.asarray(prec),
                                 jnp.zeros(K), jnp.asarray(dterm))
    assert np.allclose(np.asarray(ex.diag), np.asarray(s.diag))
    assert np.allclose(np.asarray(ex.log_det_sigma),
                       np.asarray(s.log_det_sigma))


@pytest.mark.parametrize('num_pops', [1, 2])
def test_epoch_trajectory_matches_kdim(num_pops, monkeypatch):
    """The epoch representation IS the kdim fit: stepping both from the
    same (K-constant) starting point through real EM events keeps
    ELBOs, posterior means, hyper_delta, and the learned error_scaling
    equal to float rounding."""
    monkeypatch.setattr(engine, '_EPOCH_SKIP_TOL', 0.0)
    data = synthetic.synthetic_problem(num_loci=128, num_pops=num_pops,
                                       num_components=4, block_size=32,
                                       num_annotations=2, scale_se=True)
    rng = np.random.default_rng(11)
    P, I = data.marginal_effects.shape
    K = data.mixture_prec.shape[0]
    u = rng.standard_normal((P, I)) * 1e-2
    hyper = rng.uniform(0.1, 1.0, (2, K))
    hyper /= hyper.sum(axis=1, keepdims=True)

    st_e = _epoch_state(data, u, hyper, B=24)
    st_k = dataclasses.replace(
        st_e, nat_hist=None, nat_hist_scale=None, nat_hist_c=None,
        nat_hist_n=None,
        nat_mu=jnp.broadcast_to(st_e.nat_mu[None],
                                (K,) + st_e.nat_mu.shape))

    for it in range(20):
        st_e, pm_e = engine.outer_step(data, st_e, line_search_rate=2.0)
        st_k, pm_k = engine.outer_step(data, st_k, line_search_rate=2.0)
        assert np.isclose(float(st_e.elbo), float(st_k.elbo),
                          rtol=1e-9), it
        assert np.allclose(np.asarray(pm_e), np.asarray(pm_k),
                           rtol=1e-7, atol=1e-12), it
    # the comparison only means something if EM events really happened
    assert int(st_e.nat_hist_n) >= 1
    assert not np.allclose(np.asarray(st_e.error_scaling), 1.0)
    assert np.allclose(np.asarray(st_e.error_scaling),
                       np.asarray(st_k.error_scaling), rtol=1e-9)
    assert np.allclose(np.asarray(st_e.hyper_delta),
                       np.asarray(st_k.hyper_delta), rtol=1e-8)
    m_e = engine.materialize_state(data, st_e)
    m_k = engine.materialize_state(data, st_k)
    assert np.allclose(np.asarray(m_e.vi_mu), np.asarray(m_k.vi_mu),
                       rtol=1e-7, atol=1e-12)
    assert np.allclose(np.asarray(m_e.vi_delta),
                       np.asarray(m_k.vi_delta), rtol=1e-7, atol=1e-12)


def test_multipopvi_epoch_mode_and_resume(tmp_path, monkeypatch):
    """With the size threshold forced to 0, a --learn-scaling
    MultiPopVI fit selects the epoch state, matches the kdim fit,
    writes the epoch checkpoint keys, and resumes exactly."""
    np.random.seed(17)
    data = synthetic.synthetic_problem(num_loci=128, num_pops=2,
                                       num_components=3, block_size=32,
                                       scale_se=True)
    covs = np.linalg.inv(np.asarray(data.mixture_prec))
    kw = dict(
        marginal_effects=np.asarray(data.marginal_effects),
        std_errs=np.asarray(data.std_errs),
        ld_mats=[data.ld[0]] * 2,
        mixture_covs=covs, annotations=np.ones((128, 1)),
        checkpoint=False, checkpoint_freq=-1, scaled=False,
        scale_se=True, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
        num_its=25)

    # kdim golden
    np.random.seed(17)
    gold = engine.MultiPopVI(output=str(tmp_path / 'g'), **kw)
    assert not gold._epoch
    st_g = gold.optimize()

    monkeypatch.setattr(engine, '_EPOCH_SKIP_TOL', 0.0)
    monkeypatch.setattr(engine, '_EPOCH_STATE_BYTES', 0)
    np.random.seed(17)
    ep = engine.MultiPopVI(output=str(tmp_path / 'e'), **kw)
    assert ep._epoch
    st_e = ep.optimize()
    assert st_e.nat_hist is not None
    assert int(st_e.nat_hist_n) >= 1
    assert np.allclose(np.asarray(ep.real_posterior_mean(st_e)),
                       np.asarray(gold.real_posterior_mean(st_g)),
                       rtol=1e-6, atol=1e-10)
    assert np.allclose(np.asarray(st_e.error_scaling),
                       np.asarray(st_g.error_scaling), rtol=1e-8)

    dump = ep.create_dump_dict(st_e)
    for key in ('nat_u', 'nat_hist', 'nat_hist_scale', 'nat_hist_c',
                'nat_hist_n'):
        assert key in dump, key
    np.savez(tmp_path / 'ckpt.npz', **dump)
    np.random.seed(17)
    ep2 = engine.MultiPopVI(output=str(tmp_path / 'e2'), **kw)
    restored = ep2._state_from_checkpoint(np.load(tmp_path / 'ckpt.npz'))
    assert restored.nat_hist is not None
    assert np.isclose(ep.elbo_value(st_e), ep2.elbo_value(restored),
                      rtol=1e-10)
    st3 = ep2.optimize(np.load(tmp_path / 'ckpt.npz'))
    assert ep2.elbo_value(st3) >= ep.elbo_value(st_e) - 1e-8

    # a checkpoint WITHOUT epoch keys cannot seed an epoch-mode resume
    np.savez(tmp_path / 'plain.npz',
             **{k: v for k, v in dump.items()
                if not k.startswith('nat_')})
    np.random.seed(17)
    ep3 = engine.MultiPopVI(output=str(tmp_path / 'e3'), **kw)
    with pytest.raises(ValueError, match='epoch'):
        ep3._state_from_checkpoint(np.load(tmp_path / 'plain.npz'))


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 12])
def test_epoch_prologue_matches_staging(num_pops, num_annotations,
                                        monkeypatch):
    """The K-chunked epoch route (chunk width 2: several chunks and a
    padded last one) reproduces the staged epoch objective and delta
    sums."""
    data = synthetic.synthetic_problem(num_loci=300, num_pops=num_pops,
                                       num_components=5, block_size=32,
                                       num_annotations=num_annotations,
                                       scale_se=True)
    rng = np.random.default_rng(23)
    P, I = data.marginal_effects.shape
    K = data.mixture_prec.shape[0]
    hyper = rng.uniform(0.1, 1.0, (num_annotations, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    st = _epoch_state(data, rng.standard_normal((P, I)) * 1e-2, hyper,
                      B=4, seed=5)
    st = dataclasses.replace(
        st, error_scaling=jnp.asarray(rng.uniform(0.8, 1.2, P),
                                      dtype=st.nat_mu.dtype))

    want = engine._objective_epoch(data, st, st.nat_mu, st.nat_hist_c,
                                   st.hyper_delta)
    want_sums = engine._delta_sums_epoch(data, st, st.hyper_delta)
    monkeypatch.setattr(engine, '_chunk_kc', lambda *a: 2)
    monkeypatch.setattr(engine, '_use_chunked', lambda *a: True)
    got = engine._objective_epoch(data, st, st.nat_mu, st.nat_hist_c,
                                  st.hyper_delta)
    got_sums = engine._delta_sums_epoch(data, st, st.hyper_delta)
    assert np.isclose(float(want[0]), float(got[0]), rtol=1e-10)
    scale = float(np.abs(np.asarray(want[1])).max())
    assert np.allclose(np.asarray(want[1]), np.asarray(got[1]),
                       rtol=1e-9, atol=1e-9 * scale)
    assert np.allclose(np.asarray(want_sums), np.asarray(got_sums),
                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('chunked', [False, True])
def test_shard_local_epoch_matches_unsharded(chunked, monkeypatch):
    """The epoch step under the shard-local mesh (history sharded
    P(None, None, 'snp'); chunked=True runs the K-chunked route)
    reproduces the single-device epoch step."""
    from vilma_tpu.parallel import alignment, mesh as mesh_mod
    num_loci = 512
    rng = np.random.default_rng(9)
    factors, indices = [], []
    for a in range(0, num_loci, 64):
        m = rng.standard_normal((64, 64))
        factors.append(lowrank.factor_block(
            X=m @ m.T + 64 * np.eye(64), t=1.0, check_symmetric=False))
        indices.append(np.arange(a, a + 64))
    ld = blocks.pack(factors, indices, num_loci)

    std_errs = rng.uniform(0.01, 0.05, (2, num_loci))
    betas = rng.standard_normal((2, num_loci)) * std_errs * 2
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.zeros((num_loci, 2))
    annotations[np.arange(num_loci), rng.integers(0, 2, num_loci)] = 1

    def build(ld_mats, b, se, annot):
        return engine.build_model_data(
            b, se, ld_mats, annot, covs, scaled=False, scale_se=True,
            gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3))

    hyper = rng.uniform(0.1, 1.0, (2, 3))
    hyper /= hyper.sum(axis=1, keepdims=True)
    u = rng.standard_normal((2, num_loci)) * 1e-2
    if chunked:
        monkeypatch.setattr(engine, '_chunk_kc', lambda *a: 2)
        monkeypatch.setattr(engine, '_use_chunked', lambda *a: True)
    engine.outer_step.clear_cache()
    try:
        data1 = build([ld, ld], betas, std_errs, annotations)
        state1 = _epoch_state(data1, u, hyper, B=4, seed=3)
        st1, pm1 = engine.outer_step(data1, state1, line_search_rate=2.0)

        lmap, L, ok = alignment.compute_layout([ld], num_loci,
                                               n_shards=8)
        assert ok
        lds = alignment.relayout_ld(ld, lmap, L, n_shards=8)
        mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
        with jax.set_mesh(mesh):
            data2 = build(
                [lds, lds],
                alignment.relayout_rows(betas, lmap, L, fill=0.0),
                alignment.relayout_rows(std_errs, lmap, L, fill=1.0),
                alignment.relayout_annotations(annotations, lmap, L))
        state2 = _epoch_state(
            data2, np.zeros((2, L)), hyper, B=4)
        state2 = dataclasses.replace(
            state2,
            nat_mu=jnp.zeros_like(state2.nat_mu).at[..., lmap].set(
                state1.nat_mu),
            nat_hist=jnp.zeros_like(state2.nat_hist).at[..., lmap].set(
                state1.nat_hist),
            nat_hist_scale=state1.nat_hist_scale,
            nat_hist_c=state1.nat_hist_c,
            nat_hist_n=state1.nat_hist_n,
            error_scaling=state1.error_scaling,
            elbo=state1.elbo,
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
    assert np.allclose(np.asarray(st2.error_scaling),
                       np.asarray(st1.error_scaling), rtol=1e-9)
    assert int(st2.nat_hist_n) == int(st1.nat_hist_n)
