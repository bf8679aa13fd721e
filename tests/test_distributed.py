"""Multi-host input pipeline tests.

The reference has no distributed anything (SURVEY.md section 2.4); these
pin the multi-host design (SURVEY.md section 7.3 item 6):

 * sharded-assembly equivalence in-process: load_ld_sharded with a mesh
   (single process, 8 simulated devices) must produce the same operator
   as the ordinary loader;
 * true multi-process equivalence: a 2-process jax.distributed CPU
   cluster, each process eigendecomposing only its own blocks, running a
   full MultiPopVI fit under the global mesh — posterior means must match
   the single-process fit on the same inputs.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import jax

from vilma_tpu.io import load
from vilma_tpu.ops import blocks
from vilma_tpu.parallel import distributed, mesh as mesh_mod


def _build_schema(tmp_path, sizes, seed=0, shuffle_extract=False):
    """Synthetic dense-block schema; returns its manifest path.

    shuffle_extract=True permutes the extract-file rows, so every
    block's index range interleaves with every other's — the
    arbitrary-user-ordering case the virtual-order layout handles."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path / 'dist_schema')
    rows, ids = [], []
    start = 0
    for b, size in enumerate(sizes):
        idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        rho = rng.uniform(0.3, 0.9)
        np.save(f'{root}_{b}.npy', rho ** idx)
        with open(f'{root}_{b}.var', 'w') as fh:
            for i in range(size):
                name = f'snp{b}_{i}'
                ids.append(name)
                fh.write(f'{name}\t1\t{start + i + 1}\t0\tA\tT\n')
        rows.append(f'{root}_{b}.var\t{root}_{b}.npy')
        start += size
    with open(root + '.schema', 'w') as fh:
        fh.write('\n'.join(rows) + '\n')
    if shuffle_extract:
        ids = [ids[i] for i in rng.permutation(len(ids))]
    with open(root + '.schema.extract', 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.write(''.join(f'{name}\tA\tT\n' for name in ids))
    return root + '.schema'


def test_sharded_assembly_matches_plain_loader(tmp_path):
    """Single process, 8 simulated devices: the sharded-assembly path
    (size-tier buckets, make_array_from_process_local_data) must define
    the same linear operator as the ordinary loader."""
    schema = _build_schema(tmp_path, sizes=[16, 48, 16, 48, 16, 42])
    variants = pd.read_csv(schema + '.extract', sep='\t')
    plain, miss1 = load.load_ld_from_schema(schema, variants, denylist=[],
                                            ldthresh=1.0)
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    sharded, miss2 = distributed.load_ld_sharded(
        schema, variants, denylist=[], ldthresh=1.0, mesh=mesh)
    assert miss1 == miss2
    assert plain.rank == sharded.rank
    assert plain.missing == sharded.missing

    x = np.random.default_rng(1).standard_normal(plain.n)
    y_plain = np.asarray(blocks.dot(plain, x))
    with jax.set_mesh(mesh):
        y_sharded = np.asarray(jax.jit(blocks.dot)(sharded,
                                                   jax.numpy.asarray(x)))
    assert np.allclose(y_plain, y_sharded, rtol=1e-12, atol=1e-12)

    # the engine's other block ops run through the sharded form too
    with jax.set_mesh(mesh):
        inv_plain = np.asarray(blocks.inverse_dot(plain, x))
        inv_sharded = np.asarray(jax.jit(blocks.inverse_dot)(
            sharded, jax.numpy.asarray(x)))
        diag_plain = np.asarray(blocks.diag(plain))
        diag_sharded = np.asarray(jax.jit(blocks.diag)(sharded))
    assert np.allclose(inv_plain, inv_sharded, rtol=1e-10, atol=1e-10)
    assert np.allclose(diag_plain, diag_sharded, rtol=1e-12, atol=1e-12)


def test_shard_local_assembly_matches_plain_loader(tmp_path):
    """Single process, 8 simulated devices: the shard-local plan path
    (plan_sharded_load + per-shard block ownership) must define the same
    operator as the plain loader composed with the layout map, with
    shard_count == 8 and row-aligned buckets."""
    sizes = [48, 96, 130, 64, 48, 77, 200, 64]
    schema = _build_schema(tmp_path, sizes=sizes)
    variants = pd.read_csv(schema + '.extract', sep='\t')
    plain, miss1 = load.load_ld_from_schema(schema, variants, denylist=[],
                                            ldthresh=1.0)
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    plan = distributed.plan_sharded_load([(schema, [])], variants, 8)
    assert plan is not None
    sharded, miss2 = distributed.load_ld_sharded(
        schema, variants, denylist=[], ldthresh=1.0, mesh=mesh, plan=plan)
    assert miss1 == miss2
    assert sharded.shard_count == 8
    assert sharded.row_aligned
    assert plain.rank == sharded.rank
    assert plan.L % (8 * 128) == 0

    # operator equality through the layout map: y[orig] must match
    n = variants.shape[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    y_plain = np.asarray(blocks.dot(plain, x))
    from vilma_tpu.parallel import alignment
    xl = alignment.relayout_rows(x, plan.layout_map, plan.L)
    with jax.set_mesh(mesh):
        yl = np.asarray(jax.jit(blocks.dot)(sharded, jax.numpy.asarray(xl)))
        inv_l = np.asarray(jax.jit(blocks.inverse_dot)(
            sharded, jax.numpy.asarray(xl)))
        diag_l = np.asarray(jax.jit(blocks.diag)(sharded))
    assert np.allclose(y_plain, yl[plan.layout_map], rtol=1e-12,
                       atol=1e-12)
    inv_plain = np.asarray(blocks.inverse_dot(plain, x))
    diag_plain = np.asarray(blocks.diag(plain))
    assert np.allclose(inv_plain, inv_l[plan.layout_map], rtol=1e-10,
                       atol=1e-10)
    assert np.allclose(diag_plain, diag_l[plan.layout_map], rtol=1e-12,
                       atol=1e-12)
    # pad slots carry nothing
    pad_mask = np.ones(plan.L, dtype=bool)
    pad_mask[plan.layout_map] = False
    assert np.allclose(yl[pad_mask], 0.0)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _cluster_fit_matches_single_process(tmp_path, nproc, ndev,
                                        layout='shard-local',
                                        scale_se=False,
                                        shuffle_extract=False):
    """nproc-process jax.distributed CPU cluster (ndev simulated devices
    each) == single-process fit."""
    # 8 blocks, 512 SNPs: divisible by the 8-device global mesh
    schema = _build_schema(tmp_path, sizes=[64] * 8,
                           shuffle_extract=shuffle_extract)
    variants = pd.read_csv(schema + '.extract', sep='\t')

    # single-process golden (this pytest process: 8 simulated devices,
    # but run unmeshed on one device)
    from vilma_tpu.inference import MultiPopVI
    n = variants.shape[0]
    rng = np.random.default_rng(1)
    std_errs = rng.uniform(0.01, 0.05, (2, n))
    betas = rng.standard_normal((2, n)) * std_errs * 2
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.ones((n, 1))
    np.random.seed(0)
    ld, _ = load.load_ld_from_schema(schema, variants, denylist=[],
                                     ldthresh=1.0)
    vi = MultiPopVI(marginal_effects=betas, std_errs=std_errs,
                    ld_mats=[ld, ld], annotations=annotations,
                    mixture_covs=covs, checkpoint=False,
                    gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
                    num_its=15 if scale_se else 5, scale_se=scale_se)
    vi.optimize()
    expected_path = str(tmp_path / 'expected.npy')
    np.save(expected_path, vi.real_posterior_mean())

    port = _free_port()
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'distributed_worker.py')
    env = dict(os.environ)
    env['PYTHONPATH'] = (os.path.dirname(os.path.dirname(
        os.path.abspath(worker))) + os.pathsep + env.get('PYTHONPATH', ''))
    # workers configure their own XLA_FLAGS/JAX_PLATFORMS
    env.pop('XLA_FLAGS', None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), str(nproc), str(port), schema,
         expected_path, str(ndev), layout,
         'scale_se' if scale_se else 'plain'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append((proc.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and 'OK' in out, (rc, out, err[-3000:])


@pytest.mark.slow
def test_two_process_fit_matches_single_process(tmp_path):
    """Two processes on the SHARD-LOCAL layout (the production multi-host
    path since round 4): the worker also asserts the compiled outer step
    has no O(I) collectives."""
    _cluster_fit_matches_single_process(tmp_path, nproc=2, ndev=4)


@pytest.mark.slow
def test_four_process_fit_matches_single_process(tmp_path):
    """Four hosts, the target host count: four
    processes, two simulated devices each, one 8-way global snp mesh,
    shard-local layout."""
    _cluster_fit_matches_single_process(tmp_path, nproc=4, ndev=2)


@pytest.mark.slow
def test_two_process_scale_se_fit_matches_single_process(tmp_path):
    """--learn-scaling on the cluster path: the per-component compact
    [K, P, I] state shards over the mesh, EM events included."""
    _cluster_fit_matches_single_process(tmp_path, nproc=2, ndev=4,
                                        scale_se=True)


@pytest.mark.slow
def test_two_process_fit_interleaved_shard_local(tmp_path):
    """An extract file NOT sorted in genome order (every block's index
    range interleaved) must still plan the shard-local collective-free
    layout via the virtual genome order — the worker asserts
    plan is not None, shard_count > 1, AND the all-reduce-only HLO
    budget, on the formerly-gather-only fixture. (Round 4 dropped this
    case to the global-gather layout.)"""
    _cluster_fit_matches_single_process(tmp_path, nproc=2, ndev=4,
                                        shuffle_extract=True)


def test_shuffled_plan_matches_plain_loader(tmp_path):
    """In-process twin of the interleaved cluster test: a shuffled
    extract still yields a shard-local plan whose assembled operator
    matches the plain loader through the layout map."""
    sizes = [48, 96, 130, 64, 48, 77, 200, 64]
    schema = _build_schema(tmp_path, sizes=sizes, shuffle_extract=True)
    variants = pd.read_csv(schema + '.extract', sep='\t')
    plain, miss1 = load.load_ld_from_schema(schema, variants, denylist=[],
                                            ldthresh=1.0)
    mesh = mesh_mod.make_mesh(n_snp=8, n_comp=1)
    plan = distributed.plan_sharded_load([(schema, [])], variants, 8)
    assert plan is not None        # round 4 returned None here
    sharded, miss2 = distributed.load_ld_sharded(
        schema, variants, denylist=[], ldthresh=1.0, mesh=mesh, plan=plan)
    assert miss1 == miss2
    assert sharded.shard_count == 8 and sharded.row_aligned
    assert plain.rank == sharded.rank
    n = variants.shape[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    from vilma_tpu.parallel import alignment
    xl = alignment.relayout_rows(x, plan.layout_map, plan.L)
    with jax.set_mesh(mesh):
        yl = np.asarray(jax.jit(blocks.dot)(sharded, jax.numpy.asarray(xl)))
        diag_l = np.asarray(jax.jit(blocks.diag)(sharded))
    assert np.allclose(np.asarray(blocks.dot(plain, x)),
                       yl[plan.layout_map], rtol=1e-12, atol=1e-12)
    assert np.allclose(np.asarray(blocks.diag(plain)),
                       diag_l[plan.layout_map], rtol=1e-12, atol=1e-12)


def _write_sumstats(tmp_path, variants, seed=2):
    rng = np.random.default_rng(seed)
    n = variants.shape[0]
    se = rng.uniform(0.02, 0.08, n)
    frame = variants.copy()
    frame['BETA'] = rng.standard_normal(n) * se * 2
    frame['SE'] = se
    path = str(tmp_path / f'sumstats{seed}.tsv')
    frame.to_csv(path, sep='\t', index=False)
    return path


@pytest.mark.slow
def test_cli_two_process_fit(tmp_path):
    """End-to-end `vilma-tpu fit --distributed` on a manual 2-process
    cluster: rank 0's output files must match the single-process CLI.

    The variant count (509) is deliberately NOT divisible by the 8-way
    snp mesh: the shard-local layout planner pads each shard's span
    internally, so arbitrary extract lists work under --distributed
    exactly as they do single-process."""
    schema = _build_schema(tmp_path, sizes=[64] * 7 + [61])
    variants = pd.read_csv(schema + '.extract', sep='\t')
    ss1 = _write_sumstats(tmp_path, variants, seed=2)
    ss2 = _write_sumstats(tmp_path, variants, seed=3)

    env = dict(os.environ)
    env['PYTHONPATH'] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get('PYTHONPATH',
                                                           ''))
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'

    def fit_args(output, extra):
        return ([sys.executable, '-m', 'vilma_tpu.frontend', 'fit',
                 '--ld-schema', ','.join([schema, schema]),
                 '--sumstats', ','.join([ss1, ss2]),
                 '--extract', schema + '.extract',
                 '-K', '3', '--num-its', '12', '--seed', '11',
                 '--stderrscale', '1.0,1.0',
                 '--samplesizes', '100e3,100e3',
                 '--init-hg', '0.1,0.1',
                 '--output', output] + extra)

    # single-process golden
    single_out = str(tmp_path / 'single_run')
    assert subprocess.run(fit_args(single_out, []), env=env,
                          capture_output=True, timeout=600).returncode == 0

    port = _free_port()
    dist_out = str(tmp_path / 'dist_run')
    procs = [subprocess.Popen(
        fit_args(dist_out, ['--distributed',
                            '--coordinator', f'localhost:{port}',
                            '--num-processes', '2',
                            '--process-id', str(pid),
                            '--mesh', 'snp=8']),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        assert proc.returncode == 0, (out, err[-3000:])

    single = pd.read_csv(single_out + '.estimates.tsv', sep='\t')
    dist = pd.read_csv(dist_out + '.estimates.tsv', sep='\t')
    assert list(single.columns) == list(dist.columns)
    for col in single.columns:
        if single[col].dtype.kind in 'fc':
            assert np.allclose(single[col], dist[col], rtol=1e-7,
                               atol=1e-10), col
        else:
            assert (single[col] == dist[col]).all(), col
