"""Mesh-sharding tests on a simulated 8-device CPU mesh.

The reference has nothing distributed (SURVEY.md section 2.4); these tests
validate the parallel decomposition: the full jitted VI step
runs under block/SNP sharding (+ component sharding) and produces the same
numbers as the single-device run.
"""
import numpy as np
import jax

from vilma_tpu.inference import engine
from vilma_tpu.ops import blocks, lowrank
from vilma_tpu.parallel import mesh as mesh_mod
from vilma_tpu.parallel import padding
from vilma_tpu.utils import synthetic


def test_simulated_mesh_active():
    """conftest.py must deliver 8 simulated CPU devices; if the
    environment ever pre-pins another platform, FAIL (not skip) so the
    multi-device coverage cannot silently vanish."""
    assert len(jax.devices()) >= 8, (
        'the 8-device CPU simulation from tests/conftest.py is not '
        'active — sharding coverage would be lost')


def _problem():
    data = synthetic.synthetic_problem(num_loci=256, num_pops=2,
                                       num_components=2, block_size=16,
                                       num_annotations=2)
    state = synthetic.synthetic_state(data)
    return data, state


def test_sharded_step_matches_unsharded():
    data, state = _problem()
    st1, pm1 = engine.outer_step(data, state, line_search_rate=2.0)

    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    sdata = mesh_mod.shard_data(data, mesh)
    sstate = mesh_mod.shard_state(state, mesh)
    with jax.set_mesh(mesh):
        st2, pm2 = engine.outer_step(sdata, sstate, line_search_rate=2.0)

    assert np.allclose(np.asarray(pm1), np.asarray(pm2), rtol=1e-10,
                       atol=1e-12)
    # elbo is tracked via accumulated deltas of ~1e9 magnitude; reduction
    # reassociation across shards gives ~1e-6 absolute differences
    assert np.allclose(float(st1.elbo), float(st2.elbo), rtol=1e-8)
    assert np.allclose(np.asarray(st1.hyper_delta),
                       np.asarray(st2.hyper_delta), rtol=1e-10)


def test_comp_sharded_mesh():
    data, state = _problem()
    st1, pm1 = engine.outer_step(data, state, line_search_rate=2.0)
    mesh = mesh_mod.make_mesh(n_snp=4, n_comp=2)
    sdata = mesh_mod.shard_data(data, mesh)
    sstate = mesh_mod.shard_state(state, mesh)
    with jax.set_mesh(mesh):
        st2, pm2 = engine.outer_step(sdata, sstate, line_search_rate=2.0)
    assert np.allclose(np.asarray(pm1), np.asarray(pm2), rtol=1e-10,
                       atol=1e-12)


def test_sharded_step_uneven_shapes():
    """Pin the padded-shard path: I not divisible by the mesh, and LD
    blocks of mixed sizes so the pack produces multiple bucket tiers
    (each with a block count that does not divide the mesh either)."""
    num_loci = 250                       # not divisible by 8
    rng = np.random.default_rng(3)
    factors, indices = [], []
    start = 0
    sizes = [16, 48, 16, 48, 16, 48, 16, 42]   # two tiers (16 and 64)
    for n in sizes:
        idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        rho = rng.uniform(0.3, 0.9)
        factors.append(lowrank.factor_block(X=rho ** idx, t=1.0,
                                            check_symmetric=False))
        indices.append(np.arange(start, start + n))
        start += n
    assert start == num_loci
    ld = blocks.pack(factors, indices, num_loci)
    assert len(ld.buckets) == 2

    std_errs = rng.uniform(0.01, 0.05, (2, num_loci))
    betas = rng.standard_normal((2, num_loci)) * std_errs * 2
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.zeros((num_loci, 2))
    annotations[np.arange(num_loci), rng.integers(0, 2, num_loci)] = 1
    data = engine.build_model_data(
        betas, std_errs, [ld, ld], annotations, covs, scaled=False,
        scale_se=False, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3))

    # the production path (MultiPopVI with mesh=) pads to the mesh size
    pdata, orig_i = padding.pad_model_data(data, 8)
    assert orig_i == num_loci
    assert pdata.marginal_effects.shape[1] == 256
    state = synthetic.synthetic_state(pdata)
    # pad slots start (and must stay) at vi_mu == 0, as in production
    # (MultiPopVI._initialize writes fake_mu only at real slots)
    import dataclasses
    state = dataclasses.replace(
        state, vi_mu=state.vi_mu.at[:, :, num_loci:].set(0.0))

    st1, pm1 = engine.outer_step(pdata, state, line_search_rate=2.0)
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    sdata = mesh_mod.shard_data(pdata, mesh)
    sstate = mesh_mod.shard_state(state, mesh)
    with jax.set_mesh(mesh):
        st2, pm2 = engine.outer_step(sdata, sstate, line_search_rate=2.0)
    assert np.allclose(np.asarray(pm1), np.asarray(pm2), rtol=1e-10,
                       atol=1e-12)
    assert np.allclose(float(st1.elbo), float(st2.elbo), rtol=1e-8)
    # pad slots must stay exactly inert through the step
    assert np.all(np.asarray(pm2)[:, num_loci:] == 0)


def test_dryrun_multichip():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        'graft_entry', os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
            '__graft_entry__.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_shard_local_step_matches_unsharded():
    """The collective-free shard-local path (alignment n_shards +
    blocks.pack shard-major + shard_map matvec) reproduces the plain
    single-device step. Messy inputs on purpose: irregular block sizes,
    a dropped variant inside a window, and an LD-missing run."""
    import dataclasses
    num_loci = 530
    rng = np.random.default_rng(7)
    factors, indices = [], []
    bounds = [(0, 96), (96, 256), (256, 356), (376, 530)]  # gap 356-376
    for a, b in bounds:
        keep = np.setdiff1d(np.arange(a, b), [130])   # hole inside block 2
        m = rng.standard_normal((keep.size, keep.size))
        factors.append(lowrank.factor_block(
            X=m @ m.T + keep.size * np.eye(keep.size), t=1.0,
            check_symmetric=False))
        indices.append(keep)
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

    # plain single-device run in genome order
    data1 = build([ld, ld], betas, std_errs, annotations)
    state1 = synthetic.synthetic_state(data1)
    st1, pm1 = engine.outer_step(data1, state1, line_search_rate=2.0)

    # shard-local run: 8 spans, relayouted inputs
    from vilma_tpu.parallel import alignment
    lmap, L, ok = alignment.compute_layout([ld], num_loci, n_shards=8)
    assert ok and L % 8 == 0
    lds = alignment.relayout_ld(ld, lmap, L, n_shards=8)
    assert lds.shard_count == 8 and lds.row_aligned
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    with jax.set_mesh(mesh):   # shard_map matvecs need the ambient mesh
        data2 = build([lds, lds],
                      alignment.relayout_rows(betas, lmap, L, fill=0.0),
                      alignment.relayout_rows(std_errs, lmap, L, fill=1.0),
                      alignment.relayout_annotations(annotations, lmap, L))
        state2 = synthetic.synthetic_state(data2)
    # the synthetic states differ at pad slots; transplant the real slots
    # so both runs optimize the same starting point (pads stay inert)
    state2 = dataclasses.replace(
        state2,
        vi_mu=jax.numpy.zeros_like(state2.vi_mu).at[..., lmap].set(
            state1.vi_mu),
        vi_delta=jax.numpy.full_like(
            state2.vi_delta, 1.0 / state2.vi_delta.shape[0]
        ).at[..., lmap].set(state1.vi_delta),
        hyper_delta=state1.hyper_delta,
        nat_grad_vi_delta=jax.numpy.zeros_like(
            state2.nat_grad_vi_delta).at[..., lmap].set(
                state1.nat_grad_vi_delta),
        sigma=state2.sigma, L=state1.L,
        error_scaling=state1.error_scaling, elbo=state1.elbo,
        running_elbo_delta=state1.running_elbo_delta)

    sdata = mesh_mod.shard_data(data2, mesh)
    sstate = mesh_mod.shard_state(state2, mesh)
    with jax.set_mesh(mesh):
        st2, pm2 = engine.outer_step(sdata, sstate, line_search_rate=2.0)

    assert np.allclose(np.asarray(pm2)[:, lmap], np.asarray(pm1),
                       rtol=1e-9, atol=1e-11)
    assert np.allclose(np.asarray(st2.error_scaling),
                       np.asarray(st1.error_scaling), rtol=1e-9)
    # pad slots stay exactly inert
    pads = np.setdiff1d(np.arange(L), lmap)
    assert np.all(np.asarray(pm2)[:, pads] == 0)


def test_shard_local_scale_se_compact_matches_unsharded():
    """The per-component [K, P, I] compact scale_se state under the
    shard-local mesh (kdim nat sharded P(comp, None, 'snp')) reproduces
    the plain single-device compact step."""
    import dataclasses
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

    engine.outer_step.clear_cache()
    try:
        data1 = build([ld, ld], betas, std_errs, annotations)
        state1 = synthetic.synthetic_state(data1, compact=True)
        assert state1.nat_mu.ndim == 3
        st1, pm1 = engine.outer_step(data1, state1, line_search_rate=2.0)

        from vilma_tpu.parallel import alignment
        lmap, L, ok = alignment.compute_layout([ld], num_loci, n_shards=8)
        assert ok
        lds = alignment.relayout_ld(ld, lmap, L, n_shards=8)
        assert lds.shard_count == 8
        mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
        with jax.set_mesh(mesh):
            data2 = build(
                [lds, lds],
                alignment.relayout_rows(betas, lmap, L, fill=0.0),
                alignment.relayout_rows(std_errs, lmap, L, fill=1.0),
                alignment.relayout_annotations(annotations, lmap, L))
            state2 = synthetic.synthetic_state(data2, compact=True)
        state2 = dataclasses.replace(
            state2,
            nat_mu=jax.numpy.zeros_like(state2.nat_mu).at[..., lmap].set(
                state1.nat_mu),
            hyper_delta=state1.hyper_delta, L=state1.L,
            error_scaling=state1.error_scaling, elbo=state1.elbo,
            running_elbo_delta=state1.running_elbo_delta)
        sdata = mesh_mod.shard_data(data2, mesh)
        sstate = mesh_mod.shard_state(state2, mesh)
        assert sstate.nat_mu.ndim == 3
        with jax.set_mesh(mesh):
            st2, pm2 = engine.outer_step(sdata, sstate,
                                         line_search_rate=2.0)
    finally:
        engine.outer_step.clear_cache()

    assert np.allclose(np.asarray(pm2)[:, lmap], np.asarray(pm1),
                       rtol=1e-9, atol=1e-11)
    assert np.allclose(np.asarray(st2.error_scaling),
                       np.asarray(st1.error_scaling), rtol=1e-9)
    pads = np.setdiff1d(np.arange(L), lmap)
    assert np.all(np.asarray(pm2)[:, pads] == 0)


def test_shard_local_dot_has_no_collectives():
    """The shard-local matvec must compile to ZERO cross-device
    collectives (the round-2 path paid O(I) all-gathers per call)."""
    import re
    rng = np.random.default_rng(1)
    n = 1024
    factors, indices = [], []
    for a in range(0, n, 128):
        m = rng.standard_normal((128, 128))
        factors.append(lowrank.factor_block(X=m @ m.T + 128 * np.eye(128),
                                            t=1.0, check_symmetric=False))
        indices.append(np.arange(a, a + 128))
    ld = blocks.pack(factors, indices, n, n_shards=8)
    assert ld.shard_count == 8
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    v = jax.device_put(rng.standard_normal(n), NamedSharding(mesh, P('snp')))
    with jax.set_mesh(mesh):
        hlo = jax.jit(blocks.dot).lower(ld, v).compile().as_text()
        vm = jax.device_put(rng.standard_normal((2, n)),
                            NamedSharding(mesh, P(None, 'snp')))
        hlo_m = jax.jit(blocks.dot_multi).lower(ld, vm).compile().as_text()
    pat = re.compile(r'\b(all-reduce|all-gather|reduce-scatter|'
                     r'collective-permute|all-to-all)\(')
    assert not pat.search(hlo)
    assert not pat.search(hlo_m)
