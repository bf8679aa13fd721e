"""The `make_ld_schema` command: build a block LD matrix from genotypes.

Produces the reference's on-disk schema format (reference
make_ld_schema.py:13-184): per block a `<root>_{chrom}:{block}.npy`
correlation matrix (optionally eigendecomposition-truncated to a stacked
`[U; s]` array), a `.var` variant-metadata file, and a `<root>.schema`
manifest listing them.

The computation is restructured around whole-file array operations instead
of the reference's per-SNP Python loop: genotypes are decoded in bulk by
the native reader (vilma_tpu.io.plink), block membership is a single
searchsorted over every variant at once, monomorphic screening is one
vectorized nanstd, and large blocks use a matmul-based NaN-aware
correlation (four BLAS GEMMs) instead of a per-pair loop.
"""
import logging
import os
import warnings
from pathlib import Path

import numpy as np

from vilma_tpu.io import plink, table
from vilma_tpu.ops import lowrank

# below this many SNPs a block's correlation takes the per-pair two-pass
# form of pandas.DataFrame.corr() (the reference's semantics, exact on the
# bundled examples); at or above it the O(n^2 * samples) work runs as GEMMs
_FAST_CORR_MIN_SNPS = 128


def args(super_parser):
    parser = super_parser.add_parser(
        'make_ld_schema',
        description='Build a block diagonal LD matrix from genotype data '
                    'and store it in vilma format.',
        usage='vilma-tpu make_ld_schema <options>',
    )
    parser.add_argument('-o', '--out-root', required=True, type=str,
                        help='Path for output schema')
    parser.add_argument('-b', '--block-file', required=True, type=str,
                        help='Bed file containing LD block boundaries')
    parser.add_argument('-p', '--plink-file-list', required=True, type=str,
                        help='A file where each line is the basename of '
                             'plink format genotype data for a single '
                             'chromosome.')
    parser.add_argument('--extract', required=False, type=str, default='',
                        help='A file with a column ID that specifies which '
                             'SNPs to keep. Defaults to all variants.')
    parser.add_argument('--ldthresh', required=False, type=float, default=-1,
                        help='Threshold for computing SVD. Negative: no '
                             'SVD. In [0, 1]: setting x guarantees SNPs '
                             'with r^2 > x stay linearly independent in '
                             'the decomposition.')
    return parser


def _get_ld_blocks(bedfile_name):
    """Per-chromosome LD block boundary tables from a UCSC-style bed file.

    Returns {chrom: Table[start, end] sorted by end}; overlapping
    intervals are rejected (reference make_ld_schema.py:59-61 semantics).
    Text after '#' on a line is a comment.
    """
    rows = {}
    with open(bedfile_name) as fh:
        for line in fh:
            fields = line.split('#', 1)[0].split()
            if fields:
                chrom, start, end = fields[:3]
                rows.setdefault(chrom, []).append((int(start), int(end)))
    per_chrom = {}
    for chrom, pairs in rows.items():
        pairs = np.array(sorted(pairs, key=lambda se: se[1]),
                         dtype=np.int64)
        starts, ends = pairs[:, 0], pairs[:, 1]
        if np.any(starts[1:] < ends[:-1]):
            raise ValueError('The LD-block bed file has overlapping '
                             'intervals.')
        per_chrom[chrom] = table.Table({'start': starts, 'end': ends})
    return per_chrom


def _nan_corr_fast(genos):
    """NaN-aware pairwise correlation [snps x snps] via four GEMMs.

    genos: [samples, snps] float with NaN for missing. Each pairwise
    correlation uses exactly the samples observed for both SNPs (the
    pandas.DataFrame.corr() contract) but the per-pair sums come from
    matmuls over a validity mask instead of a per-pair scan:

        n    = V.T @ V          joint observation counts
        Sx   = A.T @ V          per-pair sums of x over joint support
        Sxx  = (A*A).T @ V      per-pair sums of x^2
        Sxy  = A.T @ A          per-pair cross sums

    with A = genos zero-filled at NaN and V its validity mask.
    """
    valid = ~np.isnan(genos)
    v = valid.astype(np.float64)
    a = np.where(valid, genos, 0.0)
    n = v.T @ v
    sx = a.T @ v
    sxx = (a * a).T @ v
    sxy = a.T @ a
    with np.errstate(invalid='ignore', divide='ignore'):
        cov = sxy - sx * sx.T / n
        var_x = sxx - sx * sx / n
        denom = np.sqrt(var_x * var_x.T)
        corr = cov / denom
    corr[n < 2] = np.nan
    return corr


def _nan_corr(genos):
    """Pairwise correlation of a [samples, snps] genotype block.

    pandas.DataFrame.corr() is the semantic spec (reference
    make_ld_schema.py:78); small blocks take its per-pair two-pass form
    (`_nan_corr_pairwise`), large blocks the vectorized GEMM form, which
    matches it to ~1e-13 (see tests/test_command_units.py).
    """
    if genos.shape[1] >= _FAST_CORR_MIN_SNPS:
        return _nan_corr_fast(genos)
    return _nan_corr_pairwise(genos)


def _nan_corr_pairwise(genos):
    """Pairwise-complete Pearson correlation, pair by pair: means over
    the samples observed for both SNPs, then centered sums (NaN where
    fewer than 2 samples are shared or a column is constant there)."""
    valid = ~np.isnan(genos)
    n = genos.shape[1]
    corr = np.full((n, n), np.nan)
    for i in range(n):
        for j in range(i + 1):
            both = valid[:, i] & valid[:, j]
            if both.sum() < 2:
                continue
            x = genos[both, i] - genos[both, i].mean()
            y = genos[both, j] - genos[both, j].mean()
            denom = np.sqrt((x * x).sum() * (y * y).sum())
            if denom != 0:
                corr[i, j] = corr[j, i] = (x * y).sum() / denom
    return corr


def _assign_to_blocks(blocks, plink_data, variants=None):
    """Partition a chromosome's SNPs into LD blocks, vectorized.

    Returns {'<chrom> <block_idx>': {'SNPs': [samples, n_b] float array,
    'IDs': [[name, chrom, bp, cm, a1, a2], ...]}} with blocks keyed in
    genome order. Drops SNPs outside every block, not in `variants` (when
    given), monomorphic, or all-missing; genotype codes > 2.1 (the missing
    sentinel) become NaN. Exactly one chromosome per plink file, and it
    must appear in the bed file (reference make_ld_schema.py:96-146
    semantics).
    """
    loci = plink_data.get_loci()
    if not loci:
        return {}
    chroms = np.asarray([str(lo.chromosome) for lo in loci])
    chromosome = chroms[0]
    if chromosome not in blocks:
        raise ValueError('A plink file references a chromosome absent '
                         'from the LD-block bed file.')
    if np.any(chroms != chromosome):
        raise ValueError('Expected a single chromosome per plink '
                         'file; this one mixes several.')

    bp = np.asarray([lo.bp_position for lo in loci], dtype=np.int64)
    starts = blocks[chromosome]['start']
    ends = blocks[chromosome]['end']
    block_idx = np.searchsorted(starts, bp - 1, side='right') - 1
    in_block = block_idx >= 0
    in_block[in_block] &= bp[in_block] <= ends[block_idx[in_block]]

    keep = in_block
    if variants:
        names = np.asarray([lo.name for lo in loci], dtype=object)
        keep = keep & np.isin(names, list(variants))
    keep_rows = np.flatnonzero(keep)
    if keep_rows.size == 0:
        return {}

    genos = np.asarray(plink_data._genotypes[keep_rows], dtype=float)
    genos[genos > 2.1] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # all-NaN slices
        spread = np.nanstd(genos, axis=1)
    polymorphic = ~np.isnan(spread) & (spread != 0)
    keep_rows = keep_rows[polymorphic]
    genos = genos[polymorphic]

    out = {}
    for b in dict.fromkeys(block_idx[keep_rows].tolist()):
        members = block_idx[keep_rows] == b
        ids = [[loci[i].name, chromosome, loci[i].bp_position,
                loci[i].position, loci[i].allele1, loci[i].allele2]
               for i in keep_rows[members]]
        out['{} {}'.format(chromosome, b)] = {
            'SNPs': genos[members].T,        # samples x snps
            'IDs': ids,
        }
    return out


def _write_block(out_root, key, payload, ldthresh):
    """Write one block's .npy + .var; return its manifest line."""
    chrom, idx = key.split()
    tag = '{}_{}:{}'.format(out_root, chrom, idx)
    corrmat = _nan_corr(payload['SNPs'])
    if ldthresh >= 0:
        f = lowrank.factor_block(X=corrmat, t=ldthresh,
                                 check_symmetric=False)
        corrmat = np.vstack([f.u, f.s.reshape((1, -1))])
    np.save(tag, corrmat)
    with open(tag + '.var', 'w') as var_file:
        var_file.write(''.join('\t'.join(map(str, row)) + '\n'
                               for row in payload['IDs']))
    base = os.path.basename(tag)
    return '{}.var\t{}.npy'.format(base, base)


def _load_extract_set(extract_path):
    frame = table.read_table(extract_path)
    if 'ID' not in frame:
        raise ValueError('The extract file ' + extract_path
                         + ' has no ID column.')
    return set(frame['ID'])


def main(args):
    logging.info('Reading LD blocks from %s', args.block_file)
    ld_blocks = _get_ld_blocks(args.block_file)

    variants = None
    if args.extract:
        logging.info('Loading Variants from %s', args.extract)
        variants = _load_extract_set(args.extract)

    if os.path.exists(args.out_root + '.schema'):
        raise ValueError('Refusing to overwrite the existing manifest '
                         + args.out_root + '.schema; delete it first.')

    list_path = Path(args.plink_file_list)
    with open(list_path, 'r') as manifest:
        basenames = [line.strip() for line in manifest if line.strip()]
    for file_num, basename in enumerate(basenames, start=1):
        logging.info('Working on plink file %d', file_num)
        plink_data = plink.open_plink(str(Path(list_path.parents[0],
                                               basename)))
        logging.info('...assigning SNPs to blocks')
        blocked = _assign_to_blocks(ld_blocks, plink_data, variants)
        logging.info('...processing LD blocks')
        manifest_lines = []
        for key, payload in blocked.items():
            logging.info('...computing correlations for block %s', key)
            manifest_lines.append(_write_block(args.out_root, key, payload,
                                               args.ldthresh))
        with open(args.out_root + '.schema', 'a') as schema_file:
            schema_file.write('\n'.join(manifest_lines) + '\n')
    logging.info('Done!')
