"""Loading and matching of GWAS summary stats, annotations, and LD.

Host-side ETL: parsing with the exact column rules, allele flip/mismatch
detection, and missing-data semantics of the reference (reference
load.py:21-354), feeding the packed block tensors of vilma_tpu.ops.blocks
instead of Python block-object lists. Tables are read with the standard
library and numpy (io/table.py).
"""
import logging
from pathlib import Path

import numpy as np

from vilma_tpu.io import table
from vilma_tpu.ops import blocks as blocks_mod
from vilma_tpu.ops import lowrank

#: the columns of a loaded variant list, in output order
VARIANT_COLUMNS = ('ID', 'A1', 'A2')


def _derive_a2(t):
    """A2 = REF unless A1 == REF, in which case A2 = ALT."""
    return np.where(t['A1'] == t['REF'], t['ALT'], t['REF'])


def _id_positions(ids):
    """{ID: first position} over an ID column."""
    pos = {}
    for i, v in enumerate(ids):
        pos.setdefault(v, i)
    return pos


def load_variant_list(variant_filename):
    """Read the analysis variant list (reference load.py:21-39).

    Requires ID and A1 columns; A2 may be given directly or derived from
    REF/ALT (A2 = REF unless A1 == REF, in which case A2 = ALT). Rows
    repeated in full are kept once.
    """
    variants = table.read_table(variant_filename)
    if 'ID' not in variants:
        raise ValueError('The variant list has no ID column.')
    if 'A1' not in variants:
        raise ValueError('The variant list has no A1 column.')
    if 'A2' not in variants:
        if 'REF' not in variants or 'ALT' not in variants:
            raise ValueError('The variant list needs an A2 column (or '
                             'REF and ALT columns to derive one).')
    seen, first = set(), []
    for i, row in enumerate(zip(*(v for _, v in variants.items()))):
        if row not in seen:
            seen.add(row)
            first.append(i)
    variants = variants.take(np.asarray(first, dtype=np.int64))
    if 'A2' not in variants:
        variants['A2'] = _derive_a2(variants)
    return table.Table({c: variants[c] for c in VARIANT_COLUMNS})


def _categories(values):
    """Sorted distinct values (pandas' get_dummies order); values that do
    not sort together keep their order of first appearance."""
    distinct = list(dict.fromkeys(values.tolist()))
    try:
        return sorted(distinct)
    except TypeError:
        return distinct


def load_annotations(annotations_filename, variants):
    """One-hot annotations matched to `variants` (reference load.py:42-68).

    Returns (one_hot [num_variants, num_annotations], denylist) where
    denylist holds the indices of unannotated variants (assigned annotation
    0 in the one-hot matrix but excluded from LD).
    """
    n = variants.shape[0]
    if not annotations_filename:
        return np.ones((n, 1)), []

    annots = table.read_table(annotations_filename)
    if 'ID' not in annots:
        raise ValueError('The annotation file has no ID column.')
    if 'ANNOTATION' not in annots:
        raise ValueError('The annotation file has no ANNOTATION column.')

    pos = _id_positions(annots['ID'])
    labels = annots['ANNOTATION']
    match = [pos.get(v, -1) for v in np.asarray(variants['ID'])]
    missing = [i for i, m in enumerate(match) if m < 0
               or (isinstance(labels[m], float) and np.isnan(labels[m]))]
    if missing:
        logging.warning('No annotation found for %d of %d variants; '
                        'assigning them the first annotation category.',
                        len(missing), n)
    values = np.array([labels[m] if m >= 0 else 0 for m in match],
                      dtype=labels.dtype)
    values[missing] = 0
    cats = _categories(values)
    one_hot = np.stack([values == c for c in cats], axis=1)
    return one_hot.astype(np.float64), missing


def load_sumstats(sumstats_filename, variants):
    """Load GWAS summary statistics matched to `variants`
    (reference load.py:71-139).

    Handles OR -> log(OR) conversion, allele flip (BETA sign change) and
    mismatch detection; missing or mismatched rows get BETA=0, SE=1 and are
    reported in the returned missing list. Returns (Table with the
    variants' ID/A1/A2 plus BETA and SE, missing list).
    """
    columns = table.header(sumstats_filename)
    if 'ID' not in columns:
        raise ValueError('The summary statistics file has no ID column.')
    if 'A1' not in columns:
        raise ValueError('The summary statistics file has no A1 column.')
    a2_cols = ['A2']
    if 'A2' not in columns:
        a2_cols = ['REF', 'ALT']
        if 'REF' not in columns or 'ALT' not in columns:
            raise ValueError('The summary statistics file needs an A2 '
                             'column (or REF and ALT columns to derive '
                             'one).')
    if 'SE' not in columns:
        raise ValueError('The summary statistics file has no SE column.')
    effect_col = 'BETA'
    if 'BETA' not in columns:
        effect_col = 'OR'
        if 'OR' not in columns:
            raise ValueError('The summary statistics file needs an '
                             'effect-size column: either BETA or OR.')

    stats = table.read_table(
        sumstats_filename,
        usecols=['ID', 'A1', 'SE', effect_col] + a2_cols)
    a2 = stats['A2'] if 'A2' in stats else _derive_a2(stats)
    effect = stats[effect_col].astype(np.float64)
    beta = effect if effect_col == 'BETA' else np.log(effect)
    se = stats['SE'].astype(np.float64)

    # left join on ID: each variant takes its first sumstats row
    pos = _id_positions(stats['ID'])
    match = np.array([pos.get(v, -1) for v in np.asarray(variants['ID'])],
                     dtype=np.int64)
    found = match >= 0
    m = np.where(found, match, 0)
    v_a1 = np.asarray(variants['A1'])
    v_a2 = np.asarray(variants['A2'])
    s_a1 = stats['A1'][m]
    s_a2 = a2[m]
    stay_allele = found & (v_a1 == s_a1) & (v_a2 == s_a2)
    flip_allele = found & (v_a1 == s_a2) & (s_a1 == v_a2)
    beta = np.where(found, beta[m], np.nan)
    se = np.where(found, se[m], np.nan)
    missing = (np.isnan(beta) | np.isnan(se)
               | ((~stay_allele) & (~flip_allele)))
    logging.warning('No usable summary statistics for %d of %d variants.',
                    int(missing.sum()), missing.size)
    logging.warning('Allele order flipped for %d variants.',
                    int(flip_allele.sum()))
    beta[missing] = 0.
    se[missing] = 1.
    beta[flip_allele] = -beta[flip_allele]
    out = table.Table({c: np.asarray(variants[c]) for c in VARIANT_COLUMNS})
    out['BETA'] = beta
    out['SE'] = se
    return out, np.where(missing)[0].tolist()


def schema_iterator(schema_path):
    """Yield (.var path, .npy path) pairs from an LD schema manifest,
    resolving paths relative to the manifest (reference load.py:142-163)."""
    schema_path = Path(schema_path)
    with open(schema_path, 'r') as schema:
        for line in schema:
            snp_path, ld_path = line.split()
            yield (Path(schema_path.parents[0], snp_path),
                   Path(schema_path.parents[0], ld_path))


def load_ld_mat(ld_path, variant_indices=None, mismatch=None, signs=None):
    """Load one LD block .npy, subset/flip, return a dense matrix
    (reference load.py:166-234).

    Square arrays are dense LD; tall (n+1) x k arrays are a stacked
    eigendecomposition [eigenvectors; eigenvalues] which is reconstructed
    densely after row subsetting/sign flipping (subset eigenvectors are no
    longer orthogonal, so downstream re-factorization is required either
    way).
    """
    ld_matrix = np.load(ld_path)

    if signs is not None and not np.allclose(np.asarray(signs) ** 2, 1):
        raise ValueError('Every entry of the sign-flip vector must be '
                         '+1 or -1.')
    if len(ld_matrix.shape) == 0:
        return ld_matrix[None, None]

    num_snps = ld_matrix.shape[0]
    if ld_matrix.shape[0] > ld_matrix.shape[1]:
        num_snps -= 1
    if variant_indices is None:
        variant_indices = np.ones(num_snps, dtype=bool)
    if mismatch is None:
        mismatch = np.zeros(int(np.sum(variant_indices)), dtype=bool)
    if signs is None:
        signs = np.ones(num_snps)

    if ld_matrix.shape[0] == ld_matrix.shape[1]:
        # the dense square format is the only one that can be asymmetric
        # on disk (the stacked-eigendecomposition reconstruction below is
        # symmetric by construction); eigh reads one triangle, so a corrupt
        # file must be rejected here (reference matrix_structures.py:102-103)
        if not np.allclose(ld_matrix, ld_matrix.T):
            raise ValueError('The LD matrix on disk is not symmetric.')
        accepted = np.copy(ld_matrix[np.ix_(variant_indices,
                                            variant_indices)])
        accepted = accepted * np.outer(signs, signs)
        return accepted[np.ix_(~mismatch, ~mismatch)]

    if ld_matrix.shape[0] < ld_matrix.shape[1]:
        raise ValueError('Unrecognized LD matrix layout: wider than tall.')

    num_snps = ld_matrix.shape[0] - 1
    if num_snps != variant_indices.shape[0]:
        raise ValueError('Stacked-eigendecomposition LD matrix row count '
                         'does not match its .var file.')
    u_mat = np.copy(ld_matrix[0:num_snps])
    s_vec = np.copy(ld_matrix[num_snps])
    u_mat = u_mat[variant_indices, :]
    u_mat = np.asarray(signs).reshape((-1, 1)) * u_mat
    u_mat = np.copy(u_mat[~mismatch])
    return (u_mat * s_vec).dot(u_mat.T)


def matched_schema_entries(schema_path, variants, denylist):
    """Metadata-only pass over a schema: which rows/columns of each block
    survive variant matching, and with which allele-flip signs.

    Yields one dict per *included* manifest entry, in manifest order:
    {ld_path, variant_indices [bool over block rows], mismatch [bool over
    kept rows], signs [+-1 over kept rows], idx [genome positions of the
    finally-kept rows], num_flipped}. Reads only .var files, never the
    (potentially huge) .npy payloads — this is what lets multi-host
    loaders agree on the global block structure without every host
    touching every matrix (matching reference load.py:269-329 semantics).
    """
    ids = np.asarray(variants['ID'])
    id_pos = _id_positions(ids)
    all_a1 = np.asarray(variants['A1'])
    all_a2 = np.asarray(variants['A2'])
    for snp_path, ld_path in schema_iterator(schema_path):
        snp_metadata = table.read_table(
            snp_path, names=['ID', 'CHROM', 'BP', 'CM', 'A1', 'A2'],
            str_cols=('ID', 'CHROM', 'A1', 'A2'))
        logging.info('Reading LD block with %d variants.',
                     snp_metadata.shape[0])

        variant_indices = np.array([v in id_pos for v in snp_metadata.ID],
                                   dtype=bool)
        if np.sum(variant_indices) == 0:
            continue
        kept_ids = snp_metadata.ID[variant_indices]
        idx = np.array([id_pos[v] for v in kept_ids], dtype=np.int64)
        keep = np.isin(idx, denylist, invert=True)
        to_change = np.where(variant_indices)[0][~keep]
        variant_indices[to_change] = False
        logging.info('Keeping %.4f of this block\'s variants.',
                     np.mean(variant_indices))
        idx = idx[keep]
        if len(idx) == 0:
            continue
        signs = np.ones(len(idx))
        my_a1 = all_a1[idx]
        my_a2 = all_a2[idx]
        ld_a1 = snp_metadata.A1[variant_indices]
        ld_a2 = snp_metadata.A2[variant_indices]
        stay = (my_a1 == ld_a1) & (my_a2 == ld_a2)
        flip = (my_a1 == ld_a2) & (my_a2 == ld_a1)
        mismatch = (~flip) & (~stay)
        if len(idx[~mismatch]) == 0:
            continue
        signs[flip] = -1
        yield {
            'ld_path': ld_path,
            'variant_indices': variant_indices,
            'mismatch': mismatch,
            'signs': signs,
            'idx': idx[~mismatch],
            'num_flipped': int(flip.sum()),
        }


def load_entry_factor(entry, ldthresh, cache_dir=None):
    """Load one matched entry's .npy and eigendecompose it — the
    expensive per-block O(n^3) step.

    With `cache_dir`, the factorization is memoized on disk keyed by the
    .npy file identity (path, size, mtime), the threshold, and the exact
    variant match (kept rows, mismatches, flip signs) — so refitting the
    same LD panel (e.g. new sumstats, new hyperparameters, a resumed or
    multi-trait study) skips every eigendecomposition whose inputs are
    unchanged, while any change to the matched rows invalidates only the
    affected blocks.
    """
    key = _factor_cache_key(entry, ldthresh) if cache_dir else None
    if key is not None:
        cached = _factor_cache_get(cache_dir, key)
        if cached is not None:
            return cached
    accepted = load_ld_mat(entry['ld_path'], entry['variant_indices'],
                           entry['mismatch'], entry['signs'])
    factor = lowrank.factor_block(X=accepted, t=ldthresh,
                                  check_symmetric=False)
    if key is not None:
        _factor_cache_put(cache_dir, key, factor)
    return factor


def _factor_cache_key(entry, ldthresh):
    import hashlib
    import os
    st = os.stat(entry['ld_path'])
    h = hashlib.sha256()
    h.update(os.path.realpath(entry['ld_path']).encode())
    h.update(np.array([st.st_size, st.st_mtime_ns], dtype=np.int64))
    h.update(np.float64(ldthresh))
    h.update(np.ascontiguousarray(entry['variant_indices'], dtype=bool))
    h.update(np.ascontiguousarray(entry['mismatch'], dtype=bool))
    h.update(np.ascontiguousarray(entry['signs'], dtype=np.float64))
    return h.hexdigest()


def _factor_cache_get(cache_dir, key):
    path = Path(cache_dir) / (key + '.npz')
    if not path.exists():
        return None
    try:
        z = np.load(path)
        return lowrank.LowRankFactor(u=z['u'], s=z['s'], d=z['d'],
                                     rank=int(z['rank']))
    except Exception:
        logging.warning('Ignoring unreadable factor-cache entry %s', path)
        return None


def _factor_cache_put(cache_dir, key, factor):
    import os
    import tempfile
    path = Path(cache_dir)
    path.mkdir(parents=True, exist_ok=True)
    # atomic publish: concurrent fits sharing a cache see either nothing
    # or a complete entry, never a torn file
    fd, tmp = tempfile.mkstemp(dir=path, suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, u=factor.u, s=factor.s, d=factor.d,
                     rank=factor.rank)
        os.replace(tmp, path / (key + '.npz'))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def consume_mmap_rng_draws():
    """Consume the reference's two random-dataset-name draws per block.

    The reference's HDF5 spill path draws two random-100-char dataset
    names per block from the global numpy RNG (reference
    matrix_structures.py:31-35,120-135), which shifts every subsequent
    seeded draw (e.g. all `sim` outputs, which hardcode mmap=True,
    reference sim.py:218-224) — so mmap mode must reproduce them.
    """
    import string as _string
    chars = list(_string.ascii_letters + _string.digits)
    np.random.choice(chars, size=100)
    np.random.choice(chars, size=100)


def _log_schema_summary(n, num_missing, total_flipped):
    logging.info('Schema load complete: %d variants.', n)
    logging.warning('%d variants have no LD information and will be '
                    'treated as missing during optimization.', num_missing)
    logging.warning('Allele order flipped for %d variants while matching '
                    'LD blocks.', total_flipped)


def load_ld_from_schema(schema_path, variants, denylist, ldthresh,
                        mmap=False, dtype=np.float64, spill_dir=None,
                        u_dtype=None, cache_dir=None):
    """Load a block LD matrix from a schema, matched to `variants`
    (reference load.py:237-354).

    Returns (PackedLD ordered like `variants`, list of variant positions
    missing LD info). With `mmap`, factor payloads and the packed bucket
    tensors are staged through disk-backed memmaps under `spill_dir`
    (a tempdir by default) instead of host RAM, bounding peak host memory
    at genome scale (the reference's HDF5 spill, matrix_structures.py:
    120-135) — and the reference's mmap RNG-stream side effects are
    reproduced for seeded parity.
    """
    factors = []
    block_indices = []
    total_flipped = 0
    spill = blocks_mod.FactorSpill(spill_dir) if mmap else None
    for entry in matched_schema_entries(schema_path, variants, denylist):
        total_flipped += entry['num_flipped']
        factor = load_entry_factor(entry, ldthresh, cache_dir=cache_dir)
        if spill is not None:
            factor = spill.store(factor)
        factors.append(factor)
        block_indices.append(entry['idx'])
        if mmap:
            consume_mmap_rng_draws()

    n = variants.shape[0]
    packed = blocks_mod.pack(factors, block_indices, n, dtype=dtype,
                             spill=spill, u_dtype=u_dtype)
    list_of_missing = list(packed.missing)
    _log_schema_summary(n, len(list_of_missing), total_flipped)
    return packed, list_of_missing
