"""HBM-resident packed block-diagonal LD tensors.

The reference stores LD as a Python list of per-block low-rank objects and
loops over them on the host (reference matrix_structures.py:237-447). On an
accelerator that design serializes into thousands of tiny kernels; instead
we pack blocks into a small number of *buckets* of padded dense tensors:

    u: [B, Pmax, Rmax]   eigenvectors (rows past a block's size are zero)
    s: [B, Rmax]         eigenvalues  (entries past a block's rank are zero)
    inv_s: [B, Rmax]     reference-style pseudo-inverse of s
    d: [B, Pmax]         diagonal component
    perm: [B, Pmax]      genome index of each block row (pads -> n, a
                         sentinel one-past-the-end slot)

so that every block operation is a single batched einsum per bucket —
large, static-shaped contractions — and the permutation/missing
semantics of the reference (matrix_structures.py:246-331)
are implemented with one gather + one scatter against genome-ordered vectors.

All public ops are pure functions of a PackedLD pytree and are safe to use
inside jit/shard_map. Blocks are embarrassingly independent, so sharding the
bucket axis across a device mesh parallelizes everything; cross-device work
is only the gather/scatter of the genome-order vector.
"""
import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from vilma_tpu.ops import lowrank


# Block sizes are padded up to one of these tiers (then buckets group blocks
# sharing a tier). Tiers are powers of two, so at most ~2x padding waste.
_SIZE_TIERS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _pad_to_tier(n):
    for t in _SIZE_TIERS:
        if n <= t:
            return t
    raise ValueError(f'LD block of size {n} exceeds the maximum supported '
                     f'block size {_SIZE_TIERS[-1]}')


def _pad_rank(r):
    return max(8, int(-(-r // 8) * 8))


@dataclass(frozen=True)
class BlockBucket:
    """One bucket of equally-padded LD blocks (see module docstring)."""
    u: jnp.ndarray        # [B, Pmax, Rmax]
    s: jnp.ndarray        # [B, Rmax]
    inv_s: jnp.ndarray    # [B, Rmax]
    d: jnp.ndarray        # [B, Pmax]
    perm: jnp.ndarray     # [B, Pmax] int32, pads -> n_total
    grows: jnp.ndarray    # [B, Pmax/128] int32 gather row ids (row-aligned
    #   fast path; all-zero placeholder otherwise — see `pack`)
    srows: jnp.ndarray    # [B, Pmax/128] int32 scatter row ids (rows past a
    #   block's true extent point at a trash row)
    seq: jnp.ndarray      # [B, Pmax] int32 sequential (block-order)
    #   positions, pads -> n_total; used by matrix_power which — matching
    #   the reference — forgets the genome permutation
    #   (matrix_structures.py:410-416 constructs the powered matrix
    #   without perm=, so block results land at sequential offsets with
    #   missing indices at the end; the reference's sim goldens depend on
    #   this)

    @property
    def num_blocks(self):
        return self.u.shape[0]

    @property
    def pmax(self):
        return self.u.shape[1]

    @property
    def rmax(self):
        return self.u.shape[2]


jax.tree_util.register_dataclass(
    BlockBucket,
    data_fields=('u', 's', 'inv_s', 'd', 'perm', 'grows', 'srows', 'seq'),
    meta_fields=(),
)


@dataclass(frozen=True)
class PackedLD:
    """A symmetric block-diagonal matrix in packed bucket form.

    Equivalent of the reference BlockDiagonalMatrix
    (matrix_structures.py:237-447): implicit zero rows/columns for `missing`
    genome indices, arbitrary genome<->block permutation, lazy inverse flag.

    Static metadata (not traced): n, inverted, has_diag, rank, missing.
    """
    buckets: tuple            # tuple[BlockBucket]
    n: int                    # total number of genome indices (incl. missing)
    inverted: bool
    has_diag: bool            # True if any block has a nonzero diagonal part
    rank: float               # sum of per-block ranks (reference get_rank)
    missing: tuple            # genome indices with no LD block (sorted ints)
    row_aligned: bool         # True when every block is a contiguous
    #   128-aligned genome range with exclusive 128-rows: enables the
    #   row-wise gather/scatter path in `dot` (whole 128-element rows
    #   instead of element gathers)
    shard_count: int = 1      # >1 when the layout is shard-local: the
    #   genome axis splits into shard_count equal spans of n/shard_count
    #   slots, no block straddles a span boundary, bucket rows are
    #   shard-major with equal per-shard counts, and grows/srows hold
    #   SHARD-LOCAL row ids. `dot`/`dot_multi` then run as one
    #   jax.shard_map over the mesh 'snp' axis with ZERO collectives
    #   (the round-2 sharded path paid two O(I) all-gathers + one O(I)
    #   all-reduce per objective evaluation for the genome<->block
    #   permutation; see parallel/alignment.compute_layout)

    @property
    def shape(self):
        return (self.n, self.n)

    # ---- convenience API mirroring the reference class -------------------
    def dot(self, vector):
        return inverse_dot(self, vector) if self.inverted else dot(self, vector)

    def dot_i(self, vector, i):
        if self.inverted:
            raise NotImplementedError('dot_i with inverted matrices '
                                      'has not been implemented yet.')
        return dot_i(self, vector, i)

    def ridge_inverse_dot(self, vector, regularizer):
        if self.inverted:
            raise NotImplementedError('ridge_inverse_dot with inverted '
                                      'matrices has not been implemented '
                                      'yet.')
        return ridge_inverse_dot(self, vector, regularizer)

    def diag(self):
        if self.inverted:
            raise NotImplementedError('Getting the diagonal of an '
                                      'inverted matrix has not been '
                                      'implemented yet.')
        return diag(self)

    def matrix_power(self, power):
        return matrix_power(self, power)

    @property
    def inverse(self):
        return dataclasses.replace(self, inverted=not self.inverted)

    def get_rank(self):
        return self.rank


jax.tree_util.register_dataclass(
    PackedLD,
    data_fields=('buckets',),
    meta_fields=('n', 'inverted', 'has_diag', 'rank', 'missing',
                 'row_aligned', 'shard_count'),
)


class _SpilledFactor:
    """A LowRankFactor whose u matrix lives on disk.

    Duck-typed against lowrank.LowRankFactor for everything pack()
    touches; `.u` opens a short-lived memmap view into the spill's shared
    payload file (one fd at a time, so genome-scale schemas with
    thousands of blocks never exhaust the fd limit)."""

    def __init__(self, spill, offset, shape, dtype, s, d, rank):
        self._spill = spill
        self._offset = offset
        self._shape = shape
        self._dtype = dtype
        self.s = s
        self.d = d
        self.rank = rank

    @property
    def u(self):
        return np.memmap(self._spill.payload_path, mode='r',
                         dtype=self._dtype, shape=self._shape,
                         offset=self._offset)

    @property
    def n(self):
        return self._shape[0]

    @property
    def r(self):
        return self._shape[1]


class FactorSpill:
    """Disk-backed staging for factor payloads (`fit --mmap`).

    The reference's --mmap mode spills each block's U,V eigenvector
    matrices to an HDF5 tempfile so 60-70 GB whole-genome schemas load
    without holding everything in host RAM (reference
    matrix_structures.py:120-135, README.md:417-424). Here the same role
    is played by disk-backed numpy arrays: `store()` appends a freshly
    factored block's `u` to a shared payload file, and `pack(spill=...)`
    assembles the big bucket tensors directly into disk-backed memmaps —
    so peak *anonymous* host memory during load stays bounded by one
    block plus page cache (which the kernel reclaims under pressure),
    instead of 2x the full factor payload (factors + packed tensors
    coexisting). See tests/test_mmap_spill.py for the RLIMIT_DATA-capped
    proof.

    The backing files live in a private tempdir that is removed when the
    spill object is garbage collected; on Linux existing memmaps remain
    readable after unlink, so a PackedLD built from this spill stays
    valid for its own lifetime.
    """

    def __init__(self, spill_dir=None):
        import tempfile
        import weakref
        import shutil
        self.dir = tempfile.mkdtemp(prefix='vilma_tpu_spill_',
                                    dir=spill_dir)
        self.payload_path = os.path.join(self.dir, 'factors.bin')
        self._payload = open(self.payload_path, 'wb')
        self._buckets = 0
        self._finalizer = weakref.finalize(
            self, shutil.rmtree, self.dir, True)

    def store(self, factor):
        """Move a LowRankFactor's u matrix onto disk."""
        u = np.ascontiguousarray(factor.u)
        offset = self._payload.tell()
        self._payload.write(u.tobytes())
        self._payload.flush()
        return _SpilledFactor(self, offset, u.shape, u.dtype,
                              s=factor.s, d=factor.d, rank=factor.rank)

    def bucket_array(self, shape, dtype):
        """A writable disk-backed array for one bucket's u tensor."""
        path = os.path.join(self.dir, f'bucket{self._buckets}.npy')
        self._buckets += 1
        return np.lib.format.open_memmap(path, mode='w+', shape=shape,
                                         dtype=dtype)


def pack(factors, block_indices, n, dtype=np.float64, spill=None,
         u_dtype=None, n_shards=1):
    """Pack per-block factors into a PackedLD.

    Args:
        factors: list of lowrank.LowRankFactor, one per LD block.
        block_indices: list of int arrays; block_indices[b] gives the genome
            index of each row of block b (the reference's `perm` split by
            block, load.py:324,345).
        n: total number of genome indices. Indices not covered by any block
            are `missing` (implicit zeros, matrix_structures.py:296-299).
        dtype: element type for the packed tensors.
        spill: optional FactorSpill; when given, the dominant u bucket
            tensors are assembled into disk-backed memmaps (kept as numpy
            leaves in the pytree) instead of host RAM + device arrays.
        u_dtype: optional storage type for the eigenvector tensors alone
            (e.g. ml_dtypes.bfloat16): u dominates HBM traffic and
            capacity ~400x over s/d, and its ~0.4% bf16 rounding is far
            inside LD panel sampling noise; contractions accumulate in
            f32 via jax type promotion. Defaults to `dtype`.
        n_shards: >1 builds a shard-local layout (PackedLD.shard_count):
            requires a row-aligned layout where n divides evenly into
            n_shards 128-multiple spans and no block straddles a span
            boundary (parallel/alignment.compute_layout produces such
            layouts). Bucket rows come out shard-major with equal
            per-shard counts and grows/srows hold shard-local row ids.
    """
    if u_dtype is None:
        u_dtype = dtype
    if len(factors) != len(block_indices):
        raise ValueError('factors and block_indices must align')
    covered = (np.concatenate([np.asarray(ix) for ix in block_indices])
               if block_indices else np.array([], dtype=np.int64))
    if covered.size != np.unique(covered).size:
        raise ValueError('block_indices assign a genome index to two blocks')
    if covered.size and (covered.min() < 0 or covered.max() >= n):
        raise ValueError('block index out of range')
    missing = tuple(sorted(set(range(n)) - set(covered.tolist())))

    # sequential (insertion-order) offsets, used by matrix_power parity
    seq_starts = np.concatenate([[0], np.cumsum([f.n for f in factors])])

    groups = {}
    for pos, (f, ix) in enumerate(zip(factors, block_indices)):
        ix = np.asarray(ix, dtype=np.int32)
        if f.n != ix.shape[0]:
            raise ValueError('factor size does not match its index list')
        key = (_pad_to_tier(f.n), _pad_rank(f.r))
        groups.setdefault(key, []).append((f, ix, int(seq_starts[pos])))

    # row-aligned fast path eligibility: every block is a contiguous
    # ascending genome range starting at a multiple of 128 whose rounded
    # 128-row extents are mutually exclusive
    row_aligned = bool(block_indices)
    claimed = set()
    for f, ix in zip(factors, block_indices):
        ix = np.asarray(ix)
        if (ix.size == 0 or ix[0] % 128 != 0
                or not np.array_equal(ix, ix[0] + np.arange(ix.size))):
            row_aligned = False
            break
        rows = set(range(int(ix[0]) // 128,
                         int(ix[0]) // 128 + -(-int(ix.size) // 128)))
        if rows & claimed:
            row_aligned = False
            break
        claimed |= rows

    shard_rows = 0
    if n_shards > 1:
        # shard-local contract: the layout must come from a shard-aware
        # planner (parallel/alignment.compute_layout) — violations here
        # are layout bugs, not data conditions, hence hard errors
        if not row_aligned:
            raise ValueError('shard-local packing (n_shards > 1) requires '
                             'a row-aligned layout')
        shard_rows = n // n_shards
        if n % n_shards or shard_rows % 128:
            raise ValueError('shard-local packing needs n to divide into '
                             'n_shards spans of 128-multiple length')
        for ix in block_indices:
            ix = np.asarray(ix)
            if int(ix[0]) // shard_rows != int(ix[-1]) // shard_rows:
                raise ValueError('an LD block straddles a shard-span '
                                 'boundary; the layout planner must '
                                 'keep blocks whole per shard')

    buckets = []
    for (pmax, rmax), items in sorted(groups.items()):
        if n_shards > 1:
            # shard-major rows with equal per-shard counts, so a P('snp')
            # sharding of the block axis gives every device exactly its
            # own shard's blocks
            per_shard = [[] for _ in range(n_shards)]
            for it in items:
                per_shard[int(np.asarray(it[1])[0]) // shard_rows].append(it)
            rows_per_shard = max(len(p) for p in per_shard)
            B = n_shards * rows_per_shard
            placed = {s_i * rows_per_shard + k: it
                      for s_i, p in enumerate(per_shard)
                      for k, it in enumerate(p)}
        else:
            B = len(items)
            placed = dict(enumerate(items))
        rpb = pmax // 128 if pmax % 128 == 0 else 0
        if rpb == 0:
            row_aligned = False
            rpb = 1
        if spill is not None:
            u = spill.bucket_array((B, pmax, rmax), u_dtype)
            u[:] = 0.0
        else:
            u = np.zeros((B, pmax, rmax), dtype=u_dtype)
        s = np.zeros((B, rmax), dtype=dtype)
        inv_s = np.zeros((B, rmax), dtype=dtype)
        d = np.zeros((B, pmax), dtype=dtype)
        perm = np.full((B, pmax), n, dtype=np.int32)
        seq = np.full((B, pmax), n, dtype=np.int32)
        grows = np.zeros((B, rpb), dtype=np.int32)
        # unplaced (per-shard padding) rows produce all-zero results; -1
        # routes their writes to the trash row anyway
        srows = np.full((B, rpb), -1 if n_shards > 1 else 0,
                        dtype=np.int32)
        for b, (f, ix, start) in placed.items():
            u[b, :f.n, :f.r] = f.u
            s[b, :f.r] = f.s
            # reference inv_s semantics (matrix_structures.py:140-145):
            # 1/s for kept eigenvalues, 0 for the rank-0 sentinel.
            with np.errstate(divide='ignore'):
                iv = np.where(f.s > 0, 1.0 / np.where(f.s > 0, f.s, 1.0), 0.0)
            inv_s[b, :f.r] = iv
            d[b, :f.n] = f.d
            perm[b, :f.n] = ix
            seq[b, :f.n] = np.arange(start, start + f.n, dtype=np.int32)
            if row_aligned:
                # shard-local row ids when sharded (each device's matvec
                # sees only its own span), global otherwise
                base = ((int(ix[0]) // shard_rows) * shard_rows
                        if n_shards > 1 else 0)
                r0 = (int(ix[0]) - base) // 128
                grows[b] = r0 + np.arange(rpb)
                live = -(-f.n // 128)
                # rows past the block's live extent target a trash row
                # (index one past the padded vector; see `dot`)
                srows[b, :live] = r0 + np.arange(live)
                srows[b, live:] = -1
        if spill is not None:
            u.flush()
            # u stays a disk-backed numpy leaf; jit/device_put consumers
            # stream it to the device without a full host copy
            u_leaf = u
        else:
            u_leaf = jnp.asarray(u)
        buckets.append(BlockBucket(u=u_leaf, s=jnp.asarray(s),
                                   inv_s=jnp.asarray(inv_s),
                                   d=jnp.asarray(d),
                                   perm=jnp.asarray(perm),
                                   grows=jnp.asarray(grows),
                                   srows=jnp.asarray(srows),
                                   seq=jnp.asarray(seq)))

    has_diag = any(not np.allclose(f.d, 0) for f in factors)
    rank = float(sum(f.rank for f in factors))
    return PackedLD(buckets=tuple(buckets), n=n, inverted=False,
                    has_diag=has_diag, rank=rank, missing=missing,
                    row_aligned=row_aligned,
                    shard_count=n_shards if n_shards > 1 else 1)


def from_dense_blocks(blocks, block_indices, n, t=1.0, dtype=np.float64):
    """Convenience: factor dense symmetric blocks then pack them."""
    factors = [lowrank.factor_block(X=b, t=t) for b in blocks]
    return pack(factors, block_indices, n, dtype=dtype)


# ---------------------------------------------------------------------------
# Core ops. Each gathers genome-order vectors into bucket layout, runs one
# batched contraction per bucket, and scatter-adds results back. The extra
# sentinel slot at index n absorbs all padding reads (zeros) and writes.
# ---------------------------------------------------------------------------

def _extend(vector, pad_value=0.0):
    pad = jnp.full(vector.shape[:-1] + (1,), pad_value, vector.dtype)
    return jnp.concatenate([vector, pad], axis=-1)


def _scatter_accumulate(parts, n, dtype):
    """parts: list of (perm [B,P], values [B,P]) -> genome vector [n]."""
    out = jnp.zeros(n + 1, dtype=dtype)
    for perm, vals in parts:
        out = out.at[perm.reshape(-1)].add(vals.reshape(-1),
                                           mode='drop')
    return out[:n]


def _bucket_dot(bk, xb):
    if bk.u.dtype == jnp.bfloat16:
        # bf16 operands with f32 accumulation: a plain einsum would
        # type-promote u to f32 first, materializing a full-size
        # converted copy and forfeiting the traffic saving
        t = jnp.einsum('bpr,bp->br', bk.u, xb.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) * bk.s
        return (jnp.einsum('bpr,br->bp', bk.u, t.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
                + bk.d * xb)
    t = jnp.einsum('bpr,bp->br', bk.u, xb) * bk.s             # [B, R]
    return jnp.einsum('bpr,br->bp', bk.u, t) + bk.d * xb


def _bucket_dot_multi(bk, xb):
    """Batched-RHS bucket matvec: xb [B, C, P] -> [B, C, P].

    One pass of the batched products serves all C vectors (cohorts
    sharing an LD panel), instead of C separate matvecs."""
    if bk.u.dtype == jnp.bfloat16:
        t = jnp.einsum('bpr,bcp->bcr', bk.u, xb.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        t = t * bk.s[:, None, :]
        return (jnp.einsum('bpr,bcr->bcp', bk.u, t.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
                + bk.d[:, None, :] * xb)
    t = jnp.einsum('bpr,bcp->bcr', bk.u, xb) * bk.s[:, None, :]
    return jnp.einsum('bpr,bcr->bcp', bk.u, t) + bk.d[:, None, :] * xb


def _dot_multi_rows(buckets, n, vectors):
    """Row-aligned multi-RHS body (see `_dot_rows`); also the per-shard
    local body of `_dot_multi_sharded`."""
    C = vectors.shape[0]
    max_rpb = max((bk.pmax // 128 for bk in buckets), default=1)
    rows = -(-n // 128) + max_rpb + 1
    x2 = jnp.zeros((C, rows * 128), vectors.dtype)
    x2 = x2.at[:, :n].set(vectors).reshape(C, rows, 128)
    y2 = jnp.zeros_like(x2)
    for bk in buckets:
        B, P = bk.d.shape
        xb = jnp.stack([x2[c][bk.grows].reshape(B, P) for c in range(C)],
                       axis=1)                              # [B, C, P]
        yb = _bucket_dot_multi(bk, xb)
        tgt = jnp.where(bk.srows < 0, rows - 1, bk.srows)
        for c in range(C):
            y2 = y2.at[c, tgt.reshape(-1)].add(
                yb[:, c].reshape(B * (P // 128), 128))
    return y2.reshape(C, -1)[:, :n]


def dot_multi(ld, vectors):
    """Matrix @ each of C vectors in ONE pass over the LD factors.

    vectors: [C, n] -> [C, n]. Exactly `jnp.stack([dot(ld, v) for v in
    vectors])` numerically (same per-output contraction), but the
    dominant U tensors stream from HBM once per pass instead of once
    per vector — the engine uses this for cohorts that share an LD
    matrix (engine._ld_scaled_dot, ModelData.ld_index)."""
    C, n = vectors.shape
    if ld.shard_count > 1:
        return _dot_multi_sharded(ld, vectors)
    if C == 1:
        return dot(ld, vectors[0])[None, :]
    if not ld.row_aligned:
        xs_ext = _extend(vectors)                           # [C, n+1]
        out = jnp.zeros((n + 1, C), dtype=vectors.dtype)
        for bk in ld.buckets:
            B, P = bk.d.shape
            xb = jnp.stack([xs_ext[c][bk.perm] for c in range(C)],
                           axis=1)                          # [B, C, P]
            yb = _bucket_dot_multi(bk, xb)
            out = out.at[bk.perm.reshape(-1)].add(
                jnp.moveaxis(yb, 1, 2).reshape(-1, C), mode='drop')
        return out[:n].T
    return _dot_multi_rows(ld.buckets, n, vectors)


def _dot_rows(buckets, n, vector):
    """Row-wise gather/scatter matvec for 128-aligned contiguous blocks.

    Moves whole 128-element rows instead of single elements. Whether
    that beats the element gather on a GPU is not measured yet. The
    vector is viewed as [rows, 128];
    each block reads/writes its exclusive row range (pad tails of the
    widest bucket may read into neighbours — harmless — while writes are
    routed to a trash row). Also the per-shard local body of
    `_dot_sharded` (with n = the shard's span and shard-local tables)."""
    max_rpb = max((bk.pmax // 128 for bk in buckets), default=1)
    rows = -(-n // 128) + max_rpb + 1      # slack rows + 1 trash row
    x2 = jnp.zeros((rows, 128), vector.dtype)
    x2 = x2.reshape(-1).at[:n].set(vector).reshape(rows, 128)
    y2 = jnp.zeros_like(x2)
    for bk in buckets:
        B, P = bk.d.shape
        xb = x2[bk.grows].reshape(B, P)
        yb = _bucket_dot(bk, xb)
        # srows == -1 (pad tail) routes to the trash row `rows-1`
        tgt = jnp.where(bk.srows < 0, rows - 1, bk.srows)
        y2 = y2.at[tgt.reshape(-1)].add(
            yb.reshape(B * (P // 128), 128))
    return y2.reshape(-1)[:n]


def _bucket_specs(ld):
    from jax.sharding import PartitionSpec as P
    spec = P('snp')
    return tuple(BlockBucket(u=spec, s=spec, inv_s=spec, d=spec,
                             perm=spec, grows=spec, srows=spec, seq=spec)
                 for _ in ld.buckets)


def _require_mesh():
    mesh = jax.sharding.get_abstract_mesh()
    if mesh is None or not mesh.axis_names or 'snp' not in mesh.axis_names:
        raise RuntimeError("a shard-local PackedLD (shard_count > 1) "
                           "needs an ambient mesh with a 'snp' axis: "
                           "wrap the call in jax.set_mesh(mesh)")
    return mesh


def _dot_sharded(ld, vector):
    """Collective-free sharded matvec: one shard_map over the 'snp' axis.

    Every device runs `_dot_rows` on its own span of the vector with its
    own blocks (the shard-local layout guarantees block/span alignment),
    so the genome<->block data movement never crosses devices — unlike
    the gather/scatter path, whose global row ids cost two O(I)
    all-gathers + one O(I) all-reduce per call under SPMD partitioning.
    """
    from jax.sharding import PartitionSpec as P
    _require_mesh()
    n_local = ld.n // ld.shard_count

    def local(v, buckets):
        return _dot_rows(buckets, n_local, v)

    return jax.shard_map(local, in_specs=(P('snp'), _bucket_specs(ld)),
                         out_specs=P('snp'))(vector, ld.buckets)


def _dot_multi_sharded(ld, vectors):
    from jax.sharding import PartitionSpec as P
    _require_mesh()
    n_local = ld.n // ld.shard_count

    def local(vs, buckets):
        return _dot_multi_rows(buckets, n_local, vs)

    return jax.shard_map(local,
                         in_specs=(P(None, 'snp'), _bucket_specs(ld)),
                         out_specs=P(None, 'snp'))(vectors, ld.buckets)


def dot(ld, vector):
    """Matrix @ vector (reference matrix_structures.py:389-408)."""
    if ld.shard_count > 1:
        return _dot_sharded(ld, vector)
    if ld.row_aligned:
        return _dot_rows(ld.buckets, ld.n, vector)
    x_ext = _extend(vector)
    parts = []
    for bk in ld.buckets:
        xb = x_ext[bk.perm]                                   # [B, P]
        parts.append((bk.perm, _bucket_dot(bk, xb)))
    return _scatter_accumulate(parts, ld.n, vector.dtype)


def dot_i(ld, vector, i):
    """(Matrix @ vector)[i] touching only the block containing i
    (reference matrix_structures.py:154-157,333-347). Host-side API —
    the jitted engine never uses it; compute is O(block_size * rank)
    instead of the full matvec."""
    i = int(i)
    if i in set(ld.missing):
        return 0.
    vec = np.asarray(vector)
    for bk in ld.buckets:
        perm = np.asarray(bk.perm)
        hit_b, hit_p = np.nonzero(perm == i)
        if hit_b.size == 0:
            continue
        b, p = int(hit_b[0]), int(hit_p[0])
        live = perm[b] < ld.n
        xb = np.zeros(perm.shape[1], dtype=vec.dtype)
        xb[live] = vec[perm[b][live]]
        u = np.asarray(bk.u[b])
        s = np.asarray(bk.s[b])
        d = np.asarray(bk.d[b])
        return float(u[p] @ (s * (u.T @ xb)) + d[p] * xb[p])
    raise IndexError(f'index {i} not covered by any block')


def inverse_dot(ld, vector):
    """PseudoInverse(Matrix) @ vector.

    Implements the reference's per-block inverse_dot
    (matrix_structures.py:159-196). The hot path (all fit invocations —
    schema-loaded LD always has d == 0 per block) is the jitted batched
    pseudo-inverse u @ (inv_s * (u.T @ v)). Blocks with a nonzero
    diagonal go through the host-side per-block path implementing the
    reference's remaining two branches: Woodbury for invertible d, dense
    reconstruction + rcond-tuned pinv when d is mixed zero/nonzero.
    """
    if ld.has_diag:
        return _inverse_dot_host(ld, vector)
    x_ext = _extend(vector)
    parts = []
    for bk in ld.buckets:
        xb = x_ext[bk.perm]
        t = jnp.einsum('bpr,bp->br', bk.u, xb) * bk.inv_s
        yb = jnp.einsum('bpr,br->bp', bk.u, t)
        parts.append((bk.perm, yb))
    return _scatter_accumulate(parts, ld.n, vector.dtype)


def _block_inverse_dot_np(u, s, inv_s, d, xb):
    """One block's pseudo-inverse action, numpy (the reference's three
    branches, matrix_structures.py:159-196)."""
    if np.all(np.isclose(d, 0)):
        return u @ (inv_s * (u.T @ xb))
    if np.any(np.isclose(np.abs(d), 0)):
        # mixed zero/nonzero diagonal: reconstruct densely and
        # pseudo-invert with the reference's spectrum-derived rcond
        reconst = np.diag(d) + (u * s) @ u.T
        e_vals = np.linalg.eigh(reconst)[0][::-1]
        full = np.where(np.isclose(np.cumsum(e_vals) / np.sum(e_vals),
                                   1.))[0]
        cut = full[0] if len(full) else len(e_vals) - 1
        rcond = e_vals[cut] / e_vals[0] * 0.1
        return np.linalg.pinv(reconst, rcond=rcond) @ xb
    if np.all(s == 0):
        # rank-0 sentinel with invertible d: the matrix IS diag(d).
        # (The reference's Woodbury would divide by an arbitrary
        # eigenvector here — a corner its own usage never reaches.)
        return xb / d
    # invertible diagonal: Woodbury with the reference's diag(inv_s)
    # convention (inv_s == 0 for the rank-0 sentinel)
    col_active = np.abs(u).sum(axis=0) > 0
    small = np.diag(inv_s) + u.T @ (u / d[:, None])
    # identity rows in padded rank slots keep the solve well-posed
    small[~col_active] = 0.
    small[:, ~col_active] = 0.
    small[~col_active, ~col_active] = 1.
    corr = u @ np.linalg.solve(small, u.T @ (xb / d)) / d
    return xb / d - corr


def _inverse_dot_host(ld, vector):
    vec = np.asarray(vector)
    out = np.zeros(ld.n, dtype=vec.dtype)
    for bk in ld.buckets:
        perm = np.asarray(bk.perm)
        u_all = np.asarray(bk.u)
        s_all = np.asarray(bk.s)
        inv_s_all = np.asarray(bk.inv_s)
        d_all = np.asarray(bk.d)
        for b in range(perm.shape[0]):
            live = perm[b] < ld.n
            nb = int(live.sum())
            if nb == 0:
                continue
            ix = perm[b][live]
            xb = vec[ix]
            yb = _block_inverse_dot_np(u_all[b][live], s_all[b],
                                       inv_s_all[b], d_all[b][live], xb)
            out[ix] = yb
    return out


def ridge_inverse_dot(ld, vector, regularizer):
    """Inverse(Matrix + diag(regularizer)) @ vector via per-block Woodbury.

    Matches reference BlockDiagonalMatrix.ridge_inverse_dot
    (matrix_structures.py:349-387) + LowRankMatrix.inverse_dot Woodbury
    branch (matrix_structures.py:187-196), including the reference's use of
    diag(inv_s) (with inv_s == 0 for rank-0 sentinel blocks) rather than a
    true S^{-1}. Requires the regularized diagonal to be invertible, which
    holds whenever regularizer > 0 (the only use in the fit path,
    variational_inference.py:248-251).
    """
    reg = jnp.zeros_like(vector) + regularizer
    x_ext = _extend(vector)
    # pad slots read regularizer 1.0 so divisions stay finite; their u rows
    # are zero so they contribute nothing.
    r_ext = _extend(reg, pad_value=1.0)
    parts = []
    for bk in ld.buckets:
        xb = x_ext[bk.perm]
        dp = bk.d + r_ext[bk.perm]                             # [B, P]
        x_over_d = xb / dp
        ut_xd = jnp.einsum('bpr,bp->br', bk.u, x_over_d)       # [B, R]
        mid = _woodbury_mid(bk, 1.0 / dp, ut_xd, vector.dtype)
        corr = jnp.einsum('bpr,br->bp', bk.u, mid) / dp
        yb = x_over_d - corr
        parts.append((bk.perm, yb))
    return _scatter_accumulate(parts, ld.n, vector.dtype)


def _woodbury_mid(bk, inv_dp, ut_xd, dtype):
    """solve(diag(inv_s) + u.T @ diag(inv_dp) @ u, ut_xd) per block.

    Identity rows are substituted in padded rank slots (their u columns
    are zero) so the solve is well-posed and yields zeros there.

    The [B, R, R] gram + LU temporaries dominate peak HBM at genome
    scale (a 6M-SNP bucket of 5859 512-wide blocks needs 2 x 5.7 GB),
    so blocks are processed in
    fixed-size chunks under lax.map: per-block results are independent,
    making the chunked computation numerically identical while peak
    temp memory stays ~0.5 GB. One-time setup cost; not the hot path.
    """
    B, rmax = ut_xd.shape
    eye = jnp.eye(rmax, dtype=dtype)

    def solve_chunk(args):
        u_c, inv_dp_c, inv_s_c, ut_xd_c = args
        gram = jnp.einsum('cpr,cp,cpq->crq', u_c, inv_dp_c, u_c)
        col_active = jnp.abs(u_c).sum(axis=1) > 0              # [C, R]
        small = gram + inv_s_c[:, :, None] * eye
        small = small + (~col_active)[:, :, None] * eye
        return jnp.linalg.solve(small, ut_xd_c[..., None])[..., 0]

    chunk = max(1, min(B, _WOODBURY_CHUNK_ELEMS // (rmax * rmax)))
    if chunk >= B:
        return solve_chunk((bk.u, inv_dp, bk.inv_s, ut_xd))
    n_chunks = -(-B // chunk)

    # dynamic slices of the ORIGINAL tensors (padding to a chunk
    # multiple would materialize a second copy of the multi-GB u): the
    # last chunk's start is clamped, so it overlaps the previous one —
    # overlapped blocks are recomputed with identical values and the
    # overlapping update writes them back unchanged.
    def body(i, mid):
        start = jnp.minimum(i * chunk, B - chunk)
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, start, chunk, 0)
        mid_c = solve_chunk((sl(bk.u), sl(inv_dp), sl(bk.inv_s),
                             sl(ut_xd)))
        return jax.lax.dynamic_update_slice_in_dim(mid, mid_c, start, 0)

    return jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros((B, rmax), dtype=dtype))


# bounds the chunked Woodbury solve's [C, R, R] f32 temporaries to
# ~0.5 GB (C * R * R elements)
_WOODBURY_CHUNK_ELEMS = 2 ** 27


def diag(ld):
    """Diagonal of the matrix (reference matrix_structures.py:426-440)."""
    parts = []
    dtype = None
    for bk in ld.buckets:
        db = jnp.einsum('bpr,br,bpr->bp', bk.u, bk.s, bk.u) + bk.d
        parts.append((bk.perm, db))
        dtype = db.dtype
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    return _scatter_accumulate(parts, ld.n, dtype)


def matrix_power(ld, power):
    """Elementwise power of eigenvalues (matrix_structures.py:205-211).

    Reference-faithful quirk: the reference's BlockDiagonalMatrix
    .matrix_power rebuilds the matrix WITHOUT its permutation
    (matrix_structures.py:410-416 omits perm=), so the powered matrix maps
    block rows to sequential offsets with the missing indices at the end.
    The reference's `sim` outputs (LD-correlated noise via
    matrix_power(0.5), sim.py:151-155) depend on this, so we switch each
    bucket's scatter map from `perm` to the precomputed `seq` positions.
    """
    if ld.has_diag:
        raise NotImplementedError('Matrix powers where the diagonal '
                                  'approximation is not zero have '
                                  'not yet been implemented.')
    new_buckets = []
    for bk in ld.buckets:
        s_new = jnp.where(bk.s > 0, bk.s, 1.0) ** power * (bk.s > 0)
        inv_s_new = jnp.where(s_new > 0,
                              1.0 / jnp.where(s_new > 0, s_new, 1.0), 0.0)
        new_buckets.append(dataclasses.replace(
            bk, s=s_new.astype(bk.s.dtype),
            inv_s=inv_s_new.astype(bk.s.dtype), perm=bk.seq))
    # the sequential layout invalidates the row-aligned gather tables
    # (and with them the shard-local dispatch)
    return dataclasses.replace(ld, buckets=tuple(new_buckets),
                               row_aligned=False, shard_count=1)


def to_dense(ld):
    """Reconstruct the full dense matrix (testing only)."""
    out = np.zeros((ld.n, ld.n))
    for bk in ld.buckets:
        u = np.asarray(bk.u)
        s = np.asarray(bk.s)
        d = np.asarray(bk.d)
        perm = np.asarray(bk.perm)
        for b in range(u.shape[0]):
            rows = perm[b] < ld.n
            ix = perm[b][rows]
            dense = (u[b][rows] * s[b]) @ u[b][rows].T + np.diag(d[b][rows])
            out[np.ix_(ix, ix)] += dense
    return out
