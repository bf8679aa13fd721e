"""Benchmark: VI coordinate-ascent iterations/s on one GPU.

    python bench.py

Runs in one process, on the GPU JAX finds (it exits non-zero without
one), in the f32 fast path with bf16 LD eigenvectors, as `fit --precision
f32 --ld-precision bf16` runs. Iterations are chained on the device with
lax.fori_loop and timed with block_until_ready. Prints the device's name
and power limit, then ONE JSON line {"metric", "value", "unit",
"device"}.

The synthetic problem's LD eigendecompositions are cached on disk
(.bench_cache/) — the one-time LAPACK factorization of ~100 blocks takes
minutes and is not what this benchmark measures.
"""
import json
import os
import time
from functools import partial

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '.bench_cache')

# BENCH_SIZE=1m selects the genome-scale configuration
_SIZE = os.environ.get('BENCH_SIZE', '100k')
# BENCH_POPS=3 runs the multi-ancestry configuration (3 cohorts sharing
# one LD panel; exercises the closed-form 3x3 sigma algebra)
NUM_POPS = int(os.environ.get('BENCH_POPS', '2'))
if not 1 <= NUM_POPS <= 3:
    # the bench measures the compact-state fast path, which requires
    # the closed-form sigma algebra (models/sigma.py, P <= 3) — the
    # same gate as MultiPopVI._compact
    raise SystemExit(f'BENCH_POPS={NUM_POPS}: the benchmark supports '
                     '1-3 populations (compact state needs the '
                     'closed-form P<=3 sigma algebra)')
if os.environ.get('BENCH_LOCI'):
    # arbitrary SNP count (e.g. the 1M/N per-device sizes of a
    # multi-device scaling study)
    NUM_LOCI = int(float(os.environ['BENCH_LOCI']))
    _SIZE = f'{NUM_LOCI}loci'
elif _SIZE == '6m':
    NUM_LOCI = 6_000_000
elif _SIZE == '1m':
    NUM_LOCI = 1_000_000
else:
    NUM_LOCI = 100_000
# BENCH_SCALE_SE=1 runs the --learn-scaling configuration: the compact
# per-component [K, P, I] natural-mean state with the error-scaling EM
# (engine._update_error_scaling_compact); when that state would exceed
# engine._EPOCH_STATE_BYTES (the production grid at genome scale), the
# EPOCH-HISTORY representation runs instead, exactly as `fit` selects
# it. BENCH_EPOCH_B sets the benched epoch-buffer size (default 8; the
# per-evaluation cost grows with the buffer, so record legs at the
# representative mid-trajectory size).
SCALE_SE = os.environ.get('BENCH_SCALE_SE', '0') == '1'
EPOCH_B = int(os.environ.get('BENCH_EPOCH_B', '8'))
# BENCH_GRID=cli replaces the K=18 synthetic component ladder with the
# PRODUCTION mixture grid the CLI builds (mixture.make_simple: a
# 2-cohort -K 12 fit crosses variances x correlations x rescalings into
# ~580 components — reference vi_options.py:301-337); BENCH_GRID_K
# overrides the -K value (default 12)
GRID = os.environ.get('BENCH_GRID', '')
GRID_K = int(os.environ.get('BENCH_GRID_K', '12'))
NUM_COMPONENTS = 18
_KTAG = 'K18' if GRID != 'cli' else f'cligrid{GRID_K}'
_SIZETAG = (_SIZE if _SIZE in ('1m', '6m') or _SIZE.endswith('loci')
            else '100k')
METRIC = (f'vi_iterations_per_s_{_SIZETAG}'
          f'_snp_{NUM_POPS}pop_{_KTAG}'
          + ('_scale_se' if SCALE_SE else ''))
BLOCK_SIZE = 1024
RANK_FRAC = 0.5
# outer steps per timed chain; BENCH_STEPS overrides
N_STEPS = int(os.environ.get('BENCH_STEPS', '5'))


def _ld_u_dtype():
    # BENCH_LD_DTYPE=bf16 stores the LD eigenvector tensors in bfloat16
    # (halves the dominant device-memory traffic; see fit --ld-precision)
    if os.environ.get('BENCH_LD_DTYPE', 'bf16') == 'bf16':
        import ml_dtypes
        return ml_dtypes.bfloat16
    return None


def _packed_tag(dtype):
    u_dtype = _ld_u_dtype() or np.dtype(dtype)
    return (f'packed_{NUM_LOCI}_{BLOCK_SIZE}_{RANK_FRAC}_'
            f'{np.dtype(dtype).name}_{np.dtype(u_dtype).name}')


def _save_packed(ld, dirpath):
    """Persist a PackedLD as raw per-bucket .npy files + metadata, so the
    next run mmaps the dominant u tensors straight from the page cache
    into the device transfer instead of re-reading and re-packing the 4x
    larger f64 factor archive (at 1M SNPs: ~17 min -> seconds)."""
    import json
    import dataclasses as dc
    os.makedirs(dirpath, exist_ok=True)
    for i, bk in enumerate(ld.buckets):
        for f in dc.fields(bk):
            arr = np.asarray(getattr(bk, f.name))
            if arr.dtype.name == 'bfloat16':  # np.save can't roundtrip
                arr = arr.view(np.uint16)
            np.save(os.path.join(dirpath, f'b{i}_{f.name}.npy'), arr)
    meta = {'num_buckets': len(ld.buckets), 'n': ld.n,
            'has_diag': ld.has_diag, 'rank': ld.rank,
            'missing': list(ld.missing), 'row_aligned': ld.row_aligned,
            'u_bf16': any(np.asarray(bk.u).dtype.name == 'bfloat16'
                          for bk in ld.buckets)}
    with open(os.path.join(dirpath, 'meta.json'), 'w') as f:
        json.dump(meta, f)


def _load_packed(dirpath):
    import json
    from vilma_tpu.ops import blocks
    with open(os.path.join(dirpath, 'meta.json')) as f:
        meta = json.load(f)
    buckets = []
    for i in range(meta['num_buckets']):
        def arr(name):
            return np.load(os.path.join(dirpath, f'b{i}_{name}.npy'),
                           mmap_mode='r')
        u = arr('u')
        if meta['u_bf16']:
            import ml_dtypes
            u = u.view(ml_dtypes.bfloat16)
        # u stays a disk-backed numpy leaf (device transfer streams it);
        # the small arrays go to the default device now
        import jax.numpy as jnp
        buckets.append(blocks.BlockBucket(
            u=u, s=jnp.asarray(arr('s')), inv_s=jnp.asarray(arr('inv_s')),
            d=jnp.asarray(arr('d')), perm=jnp.asarray(arr('perm')),
            grows=jnp.asarray(arr('grows')),
            srows=jnp.asarray(arr('srows')),
            seq=jnp.asarray(arr('seq'))))
    return blocks.PackedLD(buckets=tuple(buckets), n=meta['n'],
                           inverted=False, has_diag=meta['has_diag'],
                           rank=meta['rank'],
                           missing=tuple(meta['missing']),
                           row_aligned=meta['row_aligned'])


def _gen_factors(rng_seed=0):
    """Generate the synthetic per-block factors (one-time eigh cost)."""
    from vilma_tpu.ops import lowrank
    rng = np.random.default_rng(rng_seed)
    start = 0
    while start < NUM_LOCI:
        n = min(BLOCK_SIZE, NUM_LOCI - start)
        rho = rng.uniform(0.3, 0.95)
        idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        f = lowrank.factor_block(X=rho ** idx, t=1.0,
                                 check_symmetric=False)
        r = max(1, int(f.r * RANK_FRAC))
        order = np.argsort(f.s)[::-1][:r]
        yield (lowrank.LowRankFactor(
            u=np.ascontiguousarray(f.u[:, order]),
            s=f.s[order], d=f.d, rank=int(r)),
            np.arange(start, start + n))
        start += n


def _cached_ld(dtype):
    import dataclasses as dc
    from vilma_tpu.ops import blocks, lowrank

    packed_dir = os.path.join(CACHE_DIR, _packed_tag(dtype))
    if os.path.exists(os.path.join(packed_dir, 'meta.json')):
        return _load_packed(packed_dir)

    if _ld_u_dtype() is not None:
        # derive the bf16 packed form by casting an existing full-precision
        # packed cache (2 GB cast) instead of re-reading + re-packing the
        # 4x larger f64 factor archive (~19 min at 1M SNPs)
        base_dir = os.path.join(
            CACHE_DIR, f'packed_{NUM_LOCI}_{BLOCK_SIZE}_{RANK_FRAC}_'
            f'{np.dtype(dtype).name}_{np.dtype(dtype).name}')
        if os.path.exists(os.path.join(base_dir, 'meta.json')):
            base = _load_packed(base_dir)
            u_dtype = _ld_u_dtype()
            ld = dc.replace(base, buckets=tuple(
                dc.replace(bk, u=np.asarray(bk.u).astype(u_dtype))
                for bk in base.buckets))
            _save_packed(ld, packed_dir)
            return ld

    tag = f'ld_{NUM_LOCI}_{BLOCK_SIZE}_{RANK_FRAC}'
    path = os.path.join(CACHE_DIR, tag + '.npz')
    if os.path.exists(path):
        z = np.load(path)
        nb = int(z['num_blocks'])
        factors = [lowrank.LowRankFactor(u=z[f'u{i}'], s=z[f's{i}'],
                                         d=z[f'd{i}'],
                                         rank=int(z[f'r{i}']))
                   for i in range(nb)]
        indices = [z[f'ix{i}'] for i in range(nb)]
        ld = blocks.pack(factors, indices, NUM_LOCI, dtype=dtype,
                         u_dtype=_ld_u_dtype())
        _save_packed(ld, packed_dir)
        return ld

    factors, indices = [], []
    for f, ix in _gen_factors():
        factors.append(f)
        indices.append(ix)
    os.makedirs(CACHE_DIR, exist_ok=True)
    if NUM_LOCI <= 1_000_000:
        # keep the f64 factor archive for re-packing at other dtypes;
        # at 6M SNPs it would be ~24 GB, so only the packed form is kept
        payload = {'num_blocks': len(factors)}
        for i, (f, ix) in enumerate(zip(factors, indices)):
            payload.update({f'u{i}': f.u, f's{i}': f.s, f'd{i}': f.d,
                            f'r{i}': f.rank, f'ix{i}': ix})
        np.savez(path, **payload)
    ld = blocks.pack(factors, indices, NUM_LOCI, dtype=dtype,
                     u_dtype=_ld_u_dtype())
    _save_packed(ld, packed_dir)
    return ld


def _make_covs(rng, P, betas, std_errs):
    """Mixture components: the K=18 synthetic ladder, or — BENCH_GRID=cli
    — the production covariance grid the `fit` CLI builds."""
    if GRID == 'cli':
        from vilma_tpu.models import mixture
        np.random.seed(42)       # make_simple draws from the global RNG
        mins, maxes = mixture.effect_size_ranges(betas, std_errs, False)
        # 3-cohort grids need `fit --drop-non-psd`: the reference's grid
        # formula yields infeasible pairwise-correlation combinations at
        # P >= 3 (its own CLI cannot run them; see mixture.make_simple)
        covs = mixture.make_simple(P, GRID_K, mins, maxes,
                                   drop_non_psd=(P >= 3))
        print(f'BENCH_GRID=cli: {len(covs)} mixture components '
              f'(-K {GRID_K}, {P} cohorts)', flush=True)
        return covs
    scales = np.exp(np.linspace(np.log(1e-6), np.log(1e-2),
                                NUM_COMPONENTS))
    covs = []
    for k in range(NUM_COMPONENTS):
        a = rng.standard_normal((P, P))
        corr = 0.3 * (a @ a.T) + P * np.eye(P)
        d = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(d, d)))
    return covs


def _build(dtype, device):
    import jax
    from vilma_tpu.inference import engine
    from vilma_tpu.utils import synthetic

    with jax.default_device(jax.devices('cpu')[0]):
        ld = _cached_ld(dtype)
        rng = np.random.default_rng(1)
        P = NUM_POPS
        std_errs = rng.uniform(0.01, 0.05, (P, NUM_LOCI))
        betas = rng.standard_normal((P, NUM_LOCI)) * std_errs * 2
        covs = _make_covs(rng, P, betas, std_errs)
        annotations = np.zeros((NUM_LOCI, 4))
        annotations[np.arange(NUM_LOCI),
                    rng.integers(0, 4, NUM_LOCI)] = 1
    # move the packed LD to the target device first, then run the
    # precompute jit (ridge solves, block matvecs) there rather than on
    # the host
    ld = jax.device_put(ld, device)
    with jax.default_device(device):
        data = engine.build_model_data(
            betas.astype(dtype), std_errs.astype(dtype), [ld] * P,
            annotations, covs, scaled=False, scale_se=SCALE_SE,
            gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), dtype=dtype)
        state = synthetic.synthetic_state(
            data, compact=True, epoch_b=_epoch_b(dtype, len(covs)))
    data = jax.device_put(data, device)
    state = jax.device_put(state, device)
    return data, state


def _epoch_b(dtype, num_covs):
    """Epoch-buffer size when the production selection (MultiPopVI)
    would pick the epoch-history state for this config; None = the kdim
    state (exactly the engine's own rule)."""
    if not SCALE_SE:
        return None
    from vilma_tpu.inference import engine
    kdim_bytes = (num_covs * NUM_POPS * NUM_LOCI
                  * np.dtype(dtype).itemsize)
    if kdim_bytes <= engine._EPOCH_STATE_BYTES:
        return None
    print(f'scale_se state: epoch-history representation, B={EPOCH_B} '
          f'(kdim state would be {kdim_bytes / 2**30:.1f} GiB)',
          flush=True)
    return EPOCH_B


def _bench_steps(data, state, n_steps):
    import jax
    from jax import lax
    from vilma_tpu.inference import engine

    # donate the state: at 6M SNPs the VI state is ~3.9 GB and the old
    # buffers are dead once the chained steps return
    @partial(jax.jit, donate_argnums=(1,))
    def run(data, st):
        def body(i, st):
            st, _ = engine.outer_step_impl(data, st, line_search_rate=2.0)
            return st
        return lax.fori_loop(0, n_steps, body, st)

    out = jax.block_until_ready(run(data, state))     # compile + warmup
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(data, out))
        best = min(best, time.perf_counter() - t0)
    return n_steps / best


def _card():
    """nvidia-smi's name and power limit of the cards."""
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f'nvidia-smi unavailable: {err}'


def main():
    import sys
    import jax
    from vilma_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(f'bench.py needs a GPU; JAX found {dev.platform}',
              file=sys.stderr)
        return 1
    # x64 stays off and the matmul precision is JAX's, as in
    # `fit --precision f32`
    data, state = _build(np.float32, dev)
    value = _bench_steps(data, state, N_STEPS)
    print(f'device: {dev.device_kind} x{len(jax.devices())}; '
          f'nvidia-smi: {_card()}', flush=True)
    print(json.dumps({
        'metric': METRIC,
        'value': value,
        'unit': 'iters/s',
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }))
    return 0


def _build_mesh(dtype, n_shards):
    """Shard-local problem for the mesh scaling leg (CPU simulation or a
    real pod): same synthetic fit as _build, relayouted into n_shards
    shard-local spans (parallel/alignment) and placed on a snp mesh."""
    import jax
    from vilma_tpu.inference import engine
    from vilma_tpu.parallel import alignment, mesh as mesh_mod
    from vilma_tpu.utils import synthetic

    ld = _cached_ld(dtype)
    rng = np.random.default_rng(1)
    P = NUM_POPS
    std_errs = rng.uniform(0.01, 0.05, (P, NUM_LOCI))
    betas = rng.standard_normal((P, NUM_LOCI)) * std_errs * 2
    covs = _make_covs(rng, P, betas, std_errs)
    annotations = np.zeros((NUM_LOCI, 4))
    annotations[np.arange(NUM_LOCI), rng.integers(0, 4, NUM_LOCI)] = 1

    mesh = mesh_mod.make_mesh(n_snp=n_shards, n_comp=1)
    lmap, L, ok = alignment.compute_layout([ld], NUM_LOCI,
                                           n_shards=n_shards)
    assert ok, 'bench LD blocks must be contiguous ranges'
    lds = alignment.relayout_ld(ld, lmap, L, dtype=dtype,
                                n_shards=n_shards)
    betas = alignment.relayout_rows(betas, lmap, L, fill=0.0)
    std_errs = alignment.relayout_rows(std_errs, lmap, L, fill=1.0)
    annotations = alignment.relayout_annotations(annotations, lmap, L)
    with jax.set_mesh(mesh):
        data = engine.build_model_data(
            betas.astype(dtype), std_errs.astype(dtype), [lds] * P,
            annotations, covs, scaled=False, scale_se=SCALE_SE,
            gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), dtype=dtype)
        state = synthetic.synthetic_state(
            data, compact=True, epoch_b=_epoch_b(dtype, len(covs)))
        data = mesh_mod.shard_data(data, mesh)
        state = mesh_mod.shard_state(state, mesh)
    return mesh, data, state


def mesh_worker_main():
    """One point of the scaling curve (subprocess: the virtual device
    count must be set before backend init)."""
    import jax
    n = int(os.environ['BENCH_MESH_N'])
    jax.config.update('jax_platforms', os.environ.get(
        'BENCH_MESH_PLATFORM', 'cpu'))
    from vilma_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    dtype = np.float32
    mesh, data, state = _build_mesh(dtype, n)
    with jax.set_mesh(mesh):
        ips = _bench_steps(data, state, int(os.environ.get(
            'BENCH_MESH_STEPS', '5')))
    print('MESH_IPS', n, ips, flush=True)


def mesh_main():
    """Scaling curve: iters/s at 1/2/4/8 mesh shards.

    The devices are XLA host-platform simulations sharing the same
    cores, so the curve validates the sharded program's SHAPE (compiles,
    runs, no collective blow-up as N grows) rather than speedup. On real
    GPUs, run each point with real devices:

        fit --mesh snp=N [--distributed ...]
    """
    import subprocess
    import sys
    points = [int(x) for x in os.environ.get(
        'BENCH_MESH_POINTS', '1,2,4,8').split(',')]
    curve = {}
    for n in points:
        env = dict(os.environ)
        env['BENCH_MESH_N'] = str(n)
        env['JAX_PLATFORMS'] = 'cpu'
        env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                            + f' --xla_force_host_platform_device_count={n}'
                            ).strip()
        env['PYTHONPATH'] = (os.path.dirname(os.path.abspath(__file__))
                             + os.pathsep + env.get('PYTHONPATH', ''))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--mesh-worker'],
            capture_output=True, text=True, timeout=3600, env=env)
        for line in out.stdout.splitlines():
            if line.startswith('MESH_IPS'):
                curve[n] = float(line.split()[2])
        if n not in curve:
            print(f'mesh point N={n} failed:\n{out.stderr[-1500:]}',
                  file=sys.stderr)
    base = curve.get(points[0])
    print(json.dumps({
        'metric': f'mesh_scaling_iters_per_s_{_SIZE}_snp',
        'value': curve.get(max(curve) if curve else 0, 0.0),
        'unit': 'iters/s',
        'curve': curve,
        'relative': {n: round(v / base, 3) for n, v in curve.items()}
        if base else {},
    }))


if __name__ == '__main__':
    import sys
    if '--mesh-worker' in sys.argv:
        mesh_worker_main()
    elif '--mesh' in sys.argv:
        mesh_main()
    else:
        sys.exit(main())
