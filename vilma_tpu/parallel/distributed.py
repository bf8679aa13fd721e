"""Multi-host execution: per-process LD loading and global sharded arrays.

The reference is strictly single-process (SURVEY.md section 2.4); at
multi-host scale the input pipeline must not load or eigendecompose every
LD block on every host (SURVEY.md section 7.3 item 6). The flow here:

  1. every process runs the cheap metadata pass
     (`load.matched_schema_entries`: .var parsing + variant matching), so
     the global block structure — sizes, genome permutation, missing set,
     bucket composition — is identical on all hosts without touching any
     .npy payload;
  2. blocks are grouped into size-tier buckets and each bucket's block
     axis is split contiguously across processes (matching the 'snp' mesh
     axis layout); each process loads + eigendecomposes ONLY its own
     slice — the O(n^3) factorizations, the dominant load cost, are
     perfectly distributed;
  3. per-bucket eigendecomposition ranks (unknowable from metadata) are
     agreed via one tiny allgather, then
     `jax.make_array_from_process_local_data` assembles globally-sharded
     bucket tensors over the 'snp' mesh axis.

The result is an ordinary PackedLD whose bucket arrays are global jax
Arrays: every downstream op (engine precompute, the jitted VI step) runs
unchanged under the mesh. Single-process calls degrade to the ordinary
loader. See tests/test_distributed.py for the 2-process CPU equivalence
proof.
"""
import logging

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from vilma_tpu.io import load as load_mod
from vilma_tpu.ops import blocks as blocks_mod
from vilma_tpu.ops.blocks import BlockBucket, PackedLD, _pad_to_tier, \
    _pad_rank
from vilma_tpu.io.load import consume_mmap_rng_draws


def _round_up(n, m):
    return -(-n // m) * m


def process_contiguous_devices():
    """All devices ordered process-major, so a contiguous slice of a
    sharded axis maps to a contiguous run of each process's devices."""
    return sorted(jax.devices(), key=lambda d: (d.process_index, d.id))


def host_fetch(arr):
    """np.asarray that also works for multi-host global jax Arrays.

    Single-process (or plain numpy input): a straight np.asarray.
    Multi-process: non-fully-addressable arrays are first rereplicated
    with an all-gather (jit identity with replicated out_shardings), then
    read from the local shard — every process returns the full value.
    """
    if not isinstance(arr, jax.Array) or jax.process_count() == 1:
        return np.asarray(arr)
    if not arr.is_fully_addressable:
        mesh = arr.sharding.mesh
        arr = jax.jit(lambda x: x,
                      out_shardings=NamedSharding(mesh, P()))(arr)
    return np.asarray(arr.addressable_data(0))


def _allgather_np(values):
    """All-gather a small numpy array across processes -> [nproc, ...]."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        np.asarray(values)))


class ShardedLoadPlan:
    """Shard-local layout plan for multi-process LD loading.

    Produced by `plan_sharded_load` from a metadata-only pass (identical
    on every process); consumed by `load_ld_sharded(plan=...)`, which
    then assembles row-aligned, shard-major PackedLD buckets whose
    matvecs run collective-free under shard_map — the same fast program
    as the single-process `--align-layout` path (ops/blocks.pack
    n_shards contract)."""

    def __init__(self, layout_map, L, n_shards, entries_map):
        self.layout_map = np.asarray(layout_map, dtype=np.int32)
        self.L = int(L)
        self.n_shards = int(n_shards)
        self._entries = entries_map

    @staticmethod
    def key(schema_path, denylist):
        import os
        return (os.path.realpath(schema_path),
                tuple(sorted({int(i) for i in denylist})))

    def entries(self, schema_path, denylist):
        return self._entries[self.key(schema_path, denylist)]


def plan_sharded_load(specs, variants, n_shards):
    """Plan one shard-local layout for a multi-process fit.

    specs: [(schema_path, denylist)] in cohort order. Runs the cheap
    metadata pass (`load.matched_schema_entries`: .var parsing + variant
    matching, never an .npy payload) once per unique (schema, denylist)
    pair, then plans the union layout over all cohorts' block intervals
    with `alignment.compute_layout_from_intervals(n_shards=...)` — so a
    real pod fit gets the same collective-free shard-local spans as a
    single-process `--align-layout` run. Blocks whose index ranges
    interleave (an extract file not sorted in genome order) route
    through the virtual genome order (alignment.layout_via_virtual_order)
    instead, so EVERY valid schema plans shard-local. Returns a
    ShardedLoadPlan, or None only when the cohorts' schemas genuinely
    conflict on the relative order of shared variants (callers then fall
    back to the global-gather layout)."""
    from vilma_tpu.parallel import alignment
    n = variants.shape[0]
    entries_map, interval_lists = {}, []
    for schema_path, denylist in specs:
        key = ShardedLoadPlan.key(schema_path, denylist)
        if key not in entries_map:
            entries_map[key] = list(load_mod.matched_schema_entries(
                schema_path, variants, denylist))
        if interval_lists is not None:
            ivals = alignment.entry_intervals(entries_map[key])
            interval_lists = (None if ivals is None
                              else interval_lists + [ivals])
    if interval_lists is not None:
        layout_map, L, ok = alignment.compute_layout_from_intervals(
            interval_lists, n, n_shards=n_shards)
    else:
        block_ix_lists = [
            [np.asarray(e['idx'])
             for e in entries_map[ShardedLoadPlan.key(sp, dl)]
             if len(e['idx'])]
            for sp, dl in specs]
        layout_map, L, ok = alignment.layout_via_virtual_order(
            block_ix_lists, n, n_shards=n_shards)
    if not ok:
        return None
    return ShardedLoadPlan(layout_map, L, n_shards, entries_map)


def _load_ld_shard_local(plan, schema_path, variants, denylist, ldthresh,
                         dtype, mmap, mesh, axis, u_dtype, cache_dir):
    """Shard-local multi-process load: every process factorizes only the
    blocks whose layout spans land on its own mesh shards, and the
    assembled buckets satisfy the ops/blocks.pack(n_shards=...) contract
    (row-aligned spans, shard-major rows, shard-local grows/srows) — so
    `dot`/`dot_multi` run as one collective-free shard_map exactly as in
    single-process shard-local fits. Block independence anchor: reference
    matrix_structures.py:389-408."""
    from vilma_tpu.parallel import alignment
    from vilma_tpu.ops.blocks import _pad_to_tier as pad_to_tier

    nproc = jax.process_count()
    pid = jax.process_index()
    n_shards = plan.n_shards
    if mesh.shape[axis] != n_shards:
        raise ValueError(f'the plan was built for {n_shards} shards but '
                         f'the {axis} mesh axis has {mesh.shape[axis]} '
                         'devices')
    if n_shards % nproc:
        raise ValueError(f'{axis} mesh axis ({n_shards}) must be '
                         f'divisible by the process count ({nproc})')
    spp = n_shards // nproc
    shard_rows = plan.L // n_shards

    entries = plan.entries(schema_path, denylist)
    total_flipped = sum(e['num_flipped'] for e in entries)
    if mmap:
        for _ in entries:
            consume_mmap_rng_draws()

    # per-entry span metadata — identical on every process
    metas = []
    seq_pos = 0
    for pos, e in enumerate(entries):
        start, length, rel = alignment.block_span(plan.layout_map,
                                                  e['idx'])
        metas.append({'pos': pos, 'entry': e, 'start': start,
                      'length': length, 'rel': rel,
                      'shard': start // shard_rows, 'seq': seq_pos})
        seq_pos += length
    tiers = {}
    for m in metas:
        tiers.setdefault(pad_to_tier(m['length']), []).append(m)

    # factorize ONLY this process's shards (the O(n^3) dominant cost)
    local_factors = {}
    for m in metas:
        if pid * spp <= m['shard'] < (pid + 1) * spp:
            local_factors[m['pos']] = load_mod.load_entry_factor(
                m['entry'], ldthresh, cache_dir=cache_dir)

    # global rank agreement: one tiny allgather (ranks are unknowable
    # from metadata), exactly as the global-gather loader does
    tier_keys = sorted(tiers)
    local_rmax = np.array([
        max((local_factors[m['pos']].r for m in tiers[t]
             if m['pos'] in local_factors), default=1)
        for t in tier_keys], dtype=np.int64)
    local_rank = np.array([sum(f.rank for f in local_factors.values())],
                          dtype=np.float64)
    all_rmax = _allgather_np(local_rmax)
    all_rank = _allgather_np(local_rank)
    tier_rmax = [_pad_rank(int(r)) for r in all_rmax.max(axis=0)]
    rank = float(all_rank.sum())

    L = plan.L
    buckets = []
    for pmax, rmax in zip(tier_keys, tier_rmax):
        per_shard = [[] for _ in range(n_shards)]
        for m in tiers[pmax]:
            per_shard[m['shard']].append(m)
        rows_per_shard = max(max(len(p) for p in per_shard), 1)
        B_local = spp * rows_per_shard
        rpb = pmax // 128      # spans are 128-multiples, so pmax >= 128
        u = np.zeros((B_local, pmax, rmax), dtype=u_dtype)
        s = np.zeros((B_local, rmax), dtype=dtype)
        inv_s = np.zeros((B_local, rmax), dtype=dtype)
        d = np.zeros((B_local, pmax), dtype=dtype)
        perm = np.full((B_local, pmax), L, dtype=np.int32)
        seq = np.full((B_local, pmax), L, dtype=np.int32)
        grows = np.zeros((B_local, rpb), dtype=np.int32)
        srows = np.full((B_local, rpb), -1, dtype=np.int32)
        for shard in range(pid * spp, (pid + 1) * spp):
            for k, m in enumerate(per_shard[shard]):
                row = (shard - pid * spp) * rows_per_shard + k
                f = local_factors[m['pos']]
                # kept rows scatter into their span slots; holes/pads
                # stay zero rows (alignment.relayout_ld semantics)
                u[row, m['rel'], :f.r] = f.u
                s[row, :f.r] = f.s
                with np.errstate(divide='ignore'):
                    inv_s[row, :f.r] = np.where(
                        f.s > 0, 1.0 / np.where(f.s > 0, f.s, 1.0), 0.0)
                d[row, m['rel']] = f.d
                perm[row, :m['length']] = np.arange(
                    m['start'], m['start'] + m['length'], dtype=np.int32)
                seq[row, :m['length']] = np.arange(
                    m['seq'], m['seq'] + m['length'], dtype=np.int32)
                r0 = (m['start'] - shard * shard_rows) // 128
                grows[row] = r0 + np.arange(rpb)
                live = m['length'] // 128
                srows[row, :live] = r0 + np.arange(live)
                srows[row, live:] = -1

        def put(local, extra_dims):
            spec = P(*((axis,) + (None,) * extra_dims))
            return jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), local)

        buckets.append(BlockBucket(
            u=put(u, 2), s=put(s, 1), inv_s=put(inv_s, 1), d=put(d, 1),
            perm=put(perm, 1), grows=put(grows, 1), srows=put(srows, 1),
            seq=put(seq, 1)))

    covered = np.zeros(L, dtype=bool)
    for m in metas:
        covered[m['start']:m['start'] + m['length']] = True
    missing = tuple(np.flatnonzero(~covered).tolist())

    # LD-missing variants in ORIGINAL coordinates (for the estimates.tsv
    # missing_LD columns), matching the pre-relayout loader's return
    n_var = variants.shape[0]
    covered_orig = (np.concatenate([e['idx'] for e in entries])
                    if entries else np.array([], dtype=np.int64))
    missing_orig = sorted(set(range(n_var)) - set(covered_orig.tolist()))

    logging.info('process %d/%d: %d of %d LD blocks factorized locally '
                 '(shard-local layout: %d slots, %d shards)',
                 pid, nproc, len(local_factors), len(entries), L,
                 n_shards)
    logging.warning('%d variants have no LD information and will be '
                    'treated as missing during optimization.',
                    len(missing_orig))
    logging.warning('Allele order flipped for %d variants while matching '
                    'LD blocks.', total_flipped)
    packed = PackedLD(buckets=tuple(buckets), n=L, inverted=False,
                      has_diag=False, rank=rank, missing=missing,
                      row_aligned=True, shard_count=n_shards)
    return packed, missing_orig


def load_ld_sharded(schema_path, variants, denylist, ldthresh,
                    dtype=np.float64, mmap=False, mesh=None,
                    axis='snp', u_dtype=None, cache_dir=None,
                    plan=None, n_total=None):
    """Load an LD schema with per-process block ownership (see module
    docstring). Returns (PackedLD with globally-sharded buckets, list of
    variant positions missing LD info).

    Matches load.load_ld_from_schema semantics (reference
    load.py:237-354) exactly — same variant matching, allele flips,
    missing set, and factorization thresholds — with the work and the
    memory of the factor tensors distributed across processes.

    plan: optional ShardedLoadPlan (from `plan_sharded_load`); the load
    then produces a shard-local row-aligned PackedLD in layout
    coordinates, whose matvecs are collective-free under the mesh.
    n_total: optional padded variant count for the global-gather
    fallback — slots past len(variants) become `missing` (inert), so
    arbitrary extract lists shard evenly without a user-visible
    divisibility requirement.
    """
    if u_dtype is None:
        u_dtype = dtype
    if plan is not None:
        if mesh is None:
            raise ValueError('a shard-local plan needs the device mesh')
        return _load_ld_shard_local(plan, schema_path, variants, denylist,
                                    ldthresh, dtype, mmap, mesh, axis,
                                    u_dtype, cache_dir)
    if jax.process_count() == 1 and mesh is None:
        return load_mod.load_ld_from_schema(schema_path, variants,
                                            denylist, ldthresh,
                                            mmap=mmap, dtype=dtype,
                                            u_dtype=u_dtype,
                                            cache_dir=cache_dir)
    if mesh is None:
        raise ValueError('multi-process loads need the global device mesh')

    nproc = jax.process_count()
    pid = jax.process_index()
    n_dev = mesh.shape[axis]
    if n_dev % nproc != 0:
        raise ValueError(f'{axis} mesh axis ({n_dev}) must be divisible '
                         f'by the process count ({nproc})')

    # -- phase 1: metadata (identical on every process) -------------------
    entries = list(load_mod.matched_schema_entries(schema_path, variants,
                                                   denylist))
    total_flipped = sum(e['num_flipped'] for e in entries)
    if mmap:
        for _ in entries:
            consume_mmap_rng_draws()
    sizes = [len(e['idx']) for e in entries]
    seq_starts = np.concatenate([[0], np.cumsum(sizes)])
    n_var = variants.shape[0]
    # n_total > n_var pads the SNP axis with inert missing slots so any
    # extract-list length shards evenly over the mesh
    n = int(n_total) if n_total is not None else n_var
    covered = (np.concatenate([e['idx'] for e in entries])
               if entries else np.array([], dtype=np.int64))
    missing = tuple(sorted(set(range(n)) - set(covered.tolist())))
    missing_orig = [i for i in missing if i < n_var]

    # bucket composition from sizes alone: tier -> entry positions in
    # manifest order (rank padding is resolved by the allgather below)
    tiers = {}
    for pos, size in enumerate(sizes):
        tiers.setdefault(_pad_to_tier(size), []).append(pos)

    # -- phase 2: local factorization of owned slices ---------------------
    shard_info = []      # (pmax, B_pad, lo, hi, positions)
    local_factors = {}   # manifest position -> LowRankFactor
    for pmax in sorted(tiers):
        positions = tiers[pmax]
        B_pad = _round_up(len(positions), n_dev)
        per_proc = B_pad // nproc
        lo, hi = pid * per_proc, (pid + 1) * per_proc
        shard_info.append((pmax, B_pad, lo, hi, positions))
        for b in range(lo, min(hi, len(positions))):
            entry = entries[positions[b]]
            local_factors[positions[b]] = load_mod.load_entry_factor(
                entry, ldthresh, cache_dir=cache_dir)

    # -- phase 3: global rank agreement (one tiny allgather) --------------
    local_rmax = np.array([
        max((local_factors[p].r for p in positions[lo:hi]
             if p in local_factors), default=1)
        for (_, _, lo, hi, positions) in shard_info], dtype=np.int64)
    local_rank = np.array([sum(f.rank for f in local_factors.values())],
                          dtype=np.float64)
    all_rmax = _allgather_np(local_rmax)        # [nproc, n_buckets]
    all_rank = _allgather_np(local_rank)        # [nproc, 1]
    bucket_rmax = [_pad_rank(int(r)) for r in all_rmax.max(axis=0)]
    rank = float(all_rank.sum())

    # -- phase 4: assemble globally-sharded bucket tensors ----------------
    buckets = []
    for (pmax, B_pad, lo, hi, positions), rmax in zip(shard_info,
                                                      bucket_rmax):
        B_local = hi - lo
        u = np.zeros((B_local, pmax, rmax), dtype=u_dtype)
        s = np.zeros((B_local, rmax), dtype=dtype)
        inv_s = np.zeros((B_local, rmax), dtype=dtype)
        d = np.zeros((B_local, pmax), dtype=dtype)
        perm = np.full((B_local, pmax), n, dtype=np.int32)
        seq = np.full((B_local, pmax), n, dtype=np.int32)
        for row, b in enumerate(range(lo, min(hi, len(positions)))):
            f = local_factors[positions[b]]
            entry = entries[positions[b]]
            u[row, :f.n, :f.r] = f.u
            s[row, :f.r] = f.s
            with np.errstate(divide='ignore'):
                inv_s[row, :f.r] = np.where(
                    f.s > 0, 1.0 / np.where(f.s > 0, f.s, 1.0), 0.0)
            d[row, :f.n] = f.d
            perm[row, :f.n] = entry['idx']
            start = int(seq_starts[positions[b]])
            seq[row, :f.n] = np.arange(start, start + f.n,
                                       dtype=np.int32)

        def put(local, extra_dims):
            spec = P(*((axis,) + (None,) * extra_dims))
            return jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), local)

        rpb = 1
        grows = np.zeros((B_local, rpb), dtype=np.int32)
        srows = np.zeros((B_local, rpb), dtype=np.int32)
        buckets.append(BlockBucket(
            u=put(u, 2), s=put(s, 1), inv_s=put(inv_s, 1), d=put(d, 1),
            perm=put(perm, 1), grows=put(grows, 1), srows=put(srows, 1),
            seq=put(seq, 1)))

    logging.info('process %d/%d: %d of %d LD blocks factorized locally',
                 pid, nproc, len(local_factors), len(entries))
    packed = PackedLD(buckets=tuple(buckets), n=n, inverted=False,
                      has_diag=False, rank=rank, missing=missing,
                      row_aligned=False)
    return packed, missing_orig


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Initialize jax.distributed (idempotent).

    With no arguments, jax auto-detects the cluster (SLURM, OMPI,
    JAX_COORDINATOR_ADDRESS); explicit values support manual launches
    (fit --distributed --coordinator host:port --num-processes N
    --process-id i). A JAX process reserves most of the memory of every
    GPU it sees, so a manual launch of several processes on one GPU host
    gives each its own card through its environment
    (CUDA_VISIBLE_DEVICES=i). Only the already-initialized case is
    tolerated; real coordinator failures propagate — swallowing them
    would silently degrade a multi-host launch into N independent
    full-problem fits that all believe they are rank 0."""
    kwargs = {}
    if coordinator_address:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as err:
        if 'already' not in str(err).lower():
            raise
        logging.info('jax.distributed already initialized: %s', err)
