"""The `check_ld_schema` command: inspect and analyze LD schemas.

Covers the reference's inspection surface (reference
check_ld_schema.py:10-189): `--listvars` dumps every variant the schema
knows about, and `--trace` reports how much of the LD matrix's diagonal a
low-rank approximation retains (total and, optionally, per annotation) —
the approximation-quality diagnostic for choosing `--ldthresh`.
"""
import logging

import numpy as np

from vilma_tpu.io import load, table
from vilma_tpu.ops import blocks

_VAR_COLUMNS = ['ID', 'CHROM', 'BP', 'CM', 'A1', 'A2']


def args(super_parser):
    parser = super_parser.add_parser(
        'check_ld_schema',
        description='Utilities for analyzing LD schema.',
        usage='vilma-tpu check_ld_schema <options>',
    )
    parser.add_argument('--listvars', required=False, type=str, default='',
                        help='Path at which to print a list of all variants '
                             'present in this schema.')
    parser.add_argument('--trace', required=False, type=str, default='',
                        help='Path at which to print information about the '
                             'trace of the low rank approximation of the LD '
                             'matrix relative to its size.')
    parser.add_argument('--trace-ldthresh', required=False, type=float,
                        default=1.,
                        help='Threshold for singular value approximation of '
                             'LD matrix used when computing the trace.')
    parser.add_argument('--trace-annotations', required=False, type=str,
                        default='',
                        help='Path to an annotations file; if provided the '
                             'trace is also reported per annotation.')
    parser.add_argument('--ld-schema', required=True, type=str,
                        help='Path to LD panel schema.')
    parser.add_argument('--trace-mmap', dest='mmap', action='store_true',
                        help='Accepted for compatibility (see fit --mmap).')
    parser.add_argument('--trace-extract', required=False, type=str,
                        default='',
                        help='List of SNPs to include in trace analysis, '
                             'with ID, A1, and A2 columns.')
    return parser


def compute_trace(block_ld_mat, one_hot_annotations):
    """Trace of the (approximated) LD matrix, total and per annotation.

    A perfect-fidelity representation of an LD *correlation* matrix has
    trace == number of (non-missing) SNPs, so the reported `ratio` column
    is the fraction of signal the low-rank truncation kept (reference
    check_ld_schema.py:72-123). Rows: 'all_snps' first, then one
    'annotation_<j>' row per annotation column when there are several.
    """
    one_hot_annotations = np.asarray(one_hot_annotations)
    if not np.all(one_hot_annotations.sum(axis=1) == 1):
        raise ValueError('Annotation rows must be one-hot (exactly one '
                         '1 per row).')

    ld_diags = np.asarray(blocks.diag(block_ld_mat))
    present = np.ones(ld_diags.shape[0])
    present[list(block_ld_mat.missing)] = 0.

    labels = ['all_snps']
    traces = [ld_diags.sum()]
    counts = [present.sum()]
    num_annot = one_hot_annotations.shape[1]
    if num_annot > 1:
        labels += ['annotation_' + str(j) for j in range(num_annot)]
        traces += list(ld_diags @ one_hot_annotations)
        counts += list(present @ one_hot_annotations)

    traces = np.asarray(traces)
    counts = np.asarray(counts)
    return table.Table({'annotation': np.array(labels, dtype=object),
                        'trace': traces,
                        'num_snps': counts,
                        'ratio': traces / counts})


def combine_vars(ld_schema):
    """Concatenate every .var file of a schema into one variant table
    (reference check_ld_schema.py:126-144)."""
    frames = [table.read_table(var_path, names=_VAR_COLUMNS)
              for var_path, _ in load.schema_iterator(ld_schema)]
    return table.Table({c: np.concatenate([f[c] for f in frames])
                        for c in _VAR_COLUMNS})


def _validate(args):
    if args.trace_annotations and not args.trace:
        raise ValueError('--trace-annotations only makes sense '
                         'together with --trace.')
    if args.trace_ldthresh != 1 and not args.trace:
        raise ValueError('--trace-ldthresh only makes sense together '
                         'with --trace.')
    if not args.trace and not args.listvars:
        raise ValueError('Nothing to do: pass --trace and/or '
                         '--listvars.')


def _run_trace(args, all_vars):
    logging.info('Computing trace statistics.')
    variants = (load.load_variant_list(args.trace_extract)
                if args.trace_extract else all_vars)
    annotations, denylist = load.load_annotations(args.trace_annotations,
                                                  variants)
    ld_mat, _ = load.load_ld_from_schema(
        args.ld_schema, variants=variants, denylist=denylist,
        ldthresh=args.trace_ldthresh, mmap=args.mmap)
    table.write_tsv(args.trace, compute_trace(ld_mat, annotations))


def main(args):
    # schema diagnostics are host-side f64 work (the reference's precision)
    import jax
    jax.config.update('jax_enable_x64', True)
    jax.config.update('jax_platforms', 'cpu')
    _validate(args)

    logging.info('Collecting list of variants in LD Schema.')
    all_vars = combine_vars(args.ld_schema)

    if args.trace:
        _run_trace(args, all_vars)
    if args.listvars:
        logging.info('Saving list of variants')
        table.write_tsv(args.listvars, all_vars)
