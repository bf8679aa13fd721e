"""The `fit` command: variational inference on GWAS summary statistics.

Same argument surface, output files (.npz / .covariance.pkl /
.estimates.tsv) and checkpoint/resume semantics as the reference
(reference vi_options.py:9-281), executing on the JAX engine.
"""
import logging
import os
import pickle

import numpy as np

from vilma_tpu.io import load, table
from vilma_tpu.models import mixture


def args(super_parser):
    parser = super_parser.add_parser(
        'fit',
        description='Use variational inference to learn '
                    'effect sizes and effect size distribution '
                    'from GWAS summary data.',
        usage='vilma-tpu fit <options>',
    )
    parser.add_argument('-K', '--components', default=12, type=int,
                        help='number of mixture components in prior')
    parser.add_argument('--num-its', default=1000, type=int,
                        help='Maximum number of optimization iterations.')
    parser.add_argument('--ld-schema', required=True, type=str,
                        help='Comma-separated paths to LD panel schemas.')
    parser.add_argument('--sumstats', required=True, type=str,
                        help='Comma-separated paths to summary statistics.')
    parser.add_argument('--stderrscale', default='1.0', type=str,
                        required=False,
                        help='Comma separated list of values to multiply '
                             'summary stat stderrs by.')
    parser.add_argument('--annotations', type=str, default=None,
                        help='Path to annotation file.')
    parser.add_argument('--output', required=True, type=str,
                        help='Output path prefix.')
    parser.add_argument('--names', type=str, required=False,
                        help='Comma-separated names of the populations for '
                             'output. Defaults to 0, 1,... ')
    parser.add_argument('--extract', required=True, type=str,
                        help='List of SNPs to include in analysis, '
                             'with ID, A1, and A2 columns.')
    parser.add_argument('--scaled', dest='scaled', action='store_true',
                        help='Place the prior on frequency-scaled effect '
                             'sizes instead of natural-scale effects.')
    parser.add_argument('--ldthresh', required=False, default=1.0,
                        type=float,
                        help='Threshold for singular value approximation of '
                             'the LD matrix; --ldthresh x guarantees SNPs '
                             'with r^2 >= x stay linearly independent.')
    parser.add_argument('--seed', type=int, default=42,
                        help='Seed for random number generation.')
    parser.add_argument('--mmap', dest='mmap', action='store_true',
                        help='Stage LD factor payloads through disk-backed '
                             'memmaps while loading, bounding peak host '
                             'RAM at whole-genome schema scale; packed '
                             'blocks are then streamed to device memory '
                             'for compute.')
    parser.add_argument('--factor-cache', type=str, default='',
                        help='Directory memoizing per-block LD '
                             'eigendecompositions on disk (keyed by '
                             'matrix file identity, threshold, and the '
                             'exact variant match). Refits of the same '
                             'LD panel skip the dominant O(n^3) load '
                             'cost; changed blocks re-factorize '
                             'automatically.')
    parser.add_argument('--learn-scaling', dest='scale_se',
                        action='store_true',
                        help='Learn a scaling factor for the standard '
                             'errors.')
    parser.add_argument('--samplesizes', type=str, default='100e3',
                        help='Comma-separated GWAS sample sizes used for '
                             'initialization.')
    parser.add_argument('--init-hg', type=str, default='0.1',
                        help='Comma-separated per-population heritability '
                             'guesses used for initialization.')
    parser.add_argument('--trait', dest='trait', action='store_true',
                        help='Treat sumstats files as different traits '
                             'measured on one cohort instead of one '
                             'trait across cohorts: all traits share a '
                             'single LD panel (pass one --ld-schema) '
                             'and the mixture prior becomes a grid of '
                             'cross-TRAIT effect covariances. The '
                             'reference declared this flag but never '
                             'implemented it (vi_options.py:70-73,'
                             '134-135); here it is a supported '
                             'capability.')
    parser.add_argument('--checkpoint-freq', type=int, default=-1,
                        help='Store the model every this many iterations. '
                             'Defaults to no checkpointing.')
    parser.add_argument('--load-checkpoint', type=str, default='', nargs=2,
                        help='Resume optimization from CHECKPOINT_FILE.npz '
                             'and COVARIANCE_FILE.pkl.',
                        metavar=('CHECKPOINT_FILE.npz',
                                 'COVARIANCE_FILE.pkl'))
    parser.add_argument('--precision', type=str, default='auto',
                        choices=['auto', 'f32', 'f64'],
                        help='Numerical precision of the solver. f64 '
                             'matches the reference to float64 tolerance; '
                             'f32 is the fast path (its matrix products '
                             'may run in TF32 on a GPU; '
                             'JAX_DEFAULT_MATMUL_PRECISION=highest asks '
                             'for full f32). auto '
                             '(default) picks f32 when JAX runs on a GPU '
                             'and f64 otherwise.')
    parser.add_argument('--ld-precision', type=str, default='auto',
                        choices=['auto', 'f32', 'bf16'],
                        help='Storage precision of the LD eigenvector '
                             'tensors (the dominant device-memory traffic '
                             'and capacity). bf16 halves both; its ~0.4%% '
                             'rounding is far below LD panel sampling '
                             'noise, and contractions still accumulate '
                             'in f32. auto follows --precision.')
    parser.add_argument('--mesh', type=str, default='',
                        help='Shard the fit over a device mesh, e.g. '
                             '"snp=8" or "comp=2,snp=4". Axes: snp '
                             '(LD-block/sequence sharding), comp (mixture-'
                             'component sharding). Defaults to single-'
                             'device execution.')
    parser.add_argument('--distributed', action='store_true',
                        help='Initialize jax.distributed for multi-process '
                             'execution before building the mesh. Pass '
                             '--coordinator/--num-processes/--process-id '
                             '(or run under a cluster manager JAX '
                             'detects, such as SLURM). Processes that '
                             'share a GPU host each need their own GPU, '
                             'e.g. CUDA_VISIBLE_DEVICES=<process id>.')
    parser.add_argument('--coordinator', type=str, default='',
                        help='coordinator host:port for --distributed '
                             '(defaults to cluster auto-detection).')
    parser.add_argument('--num-processes', type=int, default=None,
                        help='total process count for --distributed '
                             'manual launches.')
    parser.add_argument('--process-id', type=int, default=None,
                        help='this process\'s rank for --distributed '
                             'manual launches.')
    parser.add_argument('--profile', type=str, default='',
                        help='Write a jax profiler trace of the '
                             'optimization to this directory '
                             '(view with TensorBoard/XProf).')
    parser.add_argument('--drop-non-psd', action='store_true',
                        help='Drop mixture-grid components whose '
                             'covariance is not positive definite. At '
                             '3+ cohorts the default grid products the '
                             'pairwise correlations independently '
                             '(reference vi_options.py:309-310), so '
                             'some combinations are infeasible and the '
                             'PSD validation rejects the whole grid — '
                             'the reference CLI cannot run a 3-cohort '
                             'fit at all. With this flag the grid is '
                             'drawn identically (same RNG stream) and '
                             'the infeasible members are removed '
                             '(logged); 2-cohort grids are unaffected '
                             '(every pairwise correlation in (-1, 1) '
                             'is PSD at P=2).')
    parser.add_argument('--no-save-vi-sigma', dest='save_vi_sigma',
                        action='store_false',
                        help='Skip the vi_sigma array in the output '
                             '.npz. The materialized [K, P, P, I] '
                             'covariances are output-only (never used '
                             'in compute) and dominate the file at '
                             'genome scale with production mixture '
                             'grids (~19 GB at 1M SNPs / ~112 GB at 6M '
                             'for a 2-cohort -K 12 grid); posterior '
                             'means/variances and all checkpoint-resume '
                             'keys are unaffected.')
    parser.add_argument('--align-layout', dest='align_layout',
                        action='store_true',
                        help='Relayout the problem so LD blocks occupy '
                             '128-aligned memory spans, enabling the '
                             'row-wise matvec gather/scatter. On by '
                             'default for f32 and under --mesh. Outputs '
                             'are identical (inert padding slots); '
                             'handles variants dropped inside LD windows '
                             'and arbitrary extract-file orderings (via '
                             'a virtual genome order); skipped only when '
                             'schemas conflict on variant order.')
    return parser


def main(args):
    np.random.seed(args.seed)

    if (not args.trait
            and args.ld_schema.count(',') != 1
            and args.ld_schema.count(',') != args.sumstats.count(',')):
        raise ValueError('Either need to input one ld_schema or provide a '
                         'sumstats file for each ld_schema.')
    if args.trait:
        # multi-trait mode (a capability the reference declared but never
        # shipped, vi_options.py:70-73): T traits measured on ONE cohort
        # share a single LD panel, and the inference runs the exact
        # multi-population machinery with the trait axis in place of the
        # population axis — the engine's identity dedup
        # (engine.ModelData.ld_index) keeps one copy of the shared panel
        # in device memory and one matvec pass per objective evaluation
        # (blocks.dot_multi).
        n_schemas = args.ld_schema.count(',') + 1
        n_traits = args.sumstats.count(',') + 1
        if n_schemas == 1 and n_traits > 1:
            args.ld_schema = ','.join([args.ld_schema] * n_traits)
        elif n_schemas != n_traits:
            raise ValueError('--trait needs one shared --ld-schema (or '
                             'one per trait).')
        if n_traits > 1:
            # The RSS likelihood treats the GWAS noise of the axis-1
            # entries (populations, here traits) as INDEPENDENT. Traits
            # measured on one cohort share individuals, so their
            # marginal-effect errors are correlated (proportional to the
            # phenotypic correlation x sample overlap); fitting them as
            # independent overstates the evidence for cross-trait effect
            # correlation (see USER_GUIDE.md "Multi-trait caveat" and
            # tests/test_trait.py::test_trait_correlated_noise_bias,
            # which pins the size of the bias on a null simulation).
            logging.warning(
                '--trait assumes INDEPENDENT GWAS noise across traits. '
                'This holds for traits measured on non-overlapping '
                'cohorts; for traits measured on the same individuals, '
                'correlated sampling noise leaks into the learned '
                'cross-trait effect-size correlation (biasing it toward '
                'the phenotypic correlation). Interpret cross-trait '
                'covariance estimates accordingly, or use '
                'non-overlapping samples per trait.')

    num_pops = args.sumstats.count(',') + 1
    names = list(map(str, range(num_pops)))
    if args.names is not None:
        if args.names.count(',') != args.sumstats.count(','):
            raise ValueError('If --names are provided, one must be '
                             'provided per sumstat file.')
        names = args.names.split(',')

    logging.info('Loading variants...')
    variants = load.load_variant_list(args.extract)

    logging.info('Loading annotations...')
    annotations, denylist = load.load_annotations(args.annotations,
                                                  variants=variants)
    missing_annot = np.zeros(len(annotations), dtype=bool)
    missing_annot[denylist] = True
    missing_sumstats = np.zeros((len(annotations), num_pops), dtype=bool)
    missing_ld_info = np.zeros((len(annotations), num_pops), dtype=bool)

    combined_ld, combined_betas, combined_errors = [], [], []
    # a single value broadcasts across populations (reference
    # vi_options.py:124-131); per-population lists must match the count
    stderr_mult = np.zeros(num_pops)
    stderr_mult[:] = list(map(float, args.stderrscale.split(',')))
    gwas_n = np.zeros(num_pops)
    gwas_n[:] = list(map(float, args.samplesizes.split(',')))
    init_hg = np.zeros(num_pops)
    init_hg[:] = list(map(float, args.init_hg.split(',')))

    # multi-process runs initialize the cluster and build the global mesh
    # BEFORE loading, so each process loads/eigendecomposes only its own
    # LD blocks (parallel.distributed.load_ld_sharded). This must also
    # happen before anything touches the backend: backend init after
    # jax.distributed.initialize() is required, not the reverse.
    if args.distributed:
        from vilma_tpu.parallel import distributed
        distributed.initialize(args.coordinator or None,
                               args.num_processes, args.process_id)
    import jax
    args.precision = _resolve_precision(args.precision)
    _configure_precision(args.precision)
    dtype = np.float64 if args.precision == 'f64' else np.float32
    u_dtype = None
    if args.ld_precision == 'bf16':
        import ml_dtypes
        u_dtype = ml_dtypes.bfloat16
    elif args.ld_precision == 'f32':
        u_dtype = np.float32
    mesh = None
    if args.mesh:
        from vilma_tpu.parallel import mesh as mesh_mod
        axes = dict(kv.split('=') for kv in args.mesh.split(','))
        mesh = mesh_mod.make_mesh(n_snp=int(axes.get('snp', 1)),
                                  n_comp=int(axes.get('comp', 1)))
    multiproc = jax.process_count() > 1

    # pass 1: sumstats for every cohort (host-side, no RNG draws — the
    # reference's seeded stream is untouched by reordering these before
    # the LD loads)
    cohort_missing = []
    for idx, sumstats_path in enumerate(args.sumstats.split(',')):
        logging.info('Loading sumstats for population %d...', idx + 1)
        sumstats, missing = load.load_sumstats(sumstats_path,
                                               variants=variants)
        missing_sumstats[missing, idx] = True
        missing.extend(denylist)
        cohort_missing.append(missing)
        combined_betas.append(np.array(sumstats.BETA).reshape((1, -1)))
        logging.info('Largest beta is... %f',
                     np.max(np.abs(np.array(sumstats.BETA))))
        combined_errors.append(np.array(sumstats.SE).reshape((1, -1))
                               * stderr_mult[idx])

    # multi-process fits plan the shard-local layout BEFORE loading: a
    # metadata-only pass over every cohort's schema plans 128-aligned
    # per-shard spans, so each process factorizes only its own blocks
    # and every matvec runs collective-free — the same fast program as
    # single-process --align-layout (parallel/distributed.py)
    plan = None
    n_pad = None
    if multiproc:
        if mesh is None:
            raise ValueError('--distributed needs a device mesh: pass '
                             '--mesh snp=<total devices across all '
                             'processes>')
        from vilma_tpu.parallel import distributed
        specs = list(zip(args.ld_schema.split(','), cohort_missing))
        plan = distributed.plan_sharded_load(specs, variants,
                                             mesh.shape['snp'])
        if plan is None:
            # only reachable when schemas CONFLICT on the relative order
            # of shared variants (arbitrary extract orderings plan fine
            # via the virtual genome order) — an order of magnitude
            # slower per evaluation than the shard-local layout
            logging.warning('The LD schemas disagree on the relative '
                            'order of shared variants; multi-process fit '
                            'falls back to the global-gather layout '
                            '(O(I) collectives per evaluation). Rebuild '
                            'the panels on a '
                            'consistent genome order to restore full '
                            'speed.')
            n_dev = mesh.shape['snp']
            n_pad = -(-variants.shape[0] // n_dev) * n_dev

    # pass 2: LD per cohort. Cohorts that share an LD panel (same
    # --ld-schema path) and mask the same variants get ONE loaded matrix:
    # the engine deduplicates LD inputs by object identity
    # (engine.ModelData.ld_index), halving both device memory and
    # per-iteration matvec traffic for the shared case
    ld_cache = {}
    for idx, (ld_schema_path, missing) in enumerate(
            zip(args.ld_schema.split(','), cohort_missing)):
        logging.info('Loading LD for population %d...', idx + 1)
        ld_key = (os.path.realpath(ld_schema_path),
                  tuple(sorted(set(missing))))
        if ld_key in ld_cache:
            logging.info('Population %d shares the LD panel of an '
                         'earlier population; reusing it.', idx + 1)
            ld_mat, this_missing_ld = ld_cache[ld_key]
        elif multiproc:
            from vilma_tpu.parallel import distributed
            ld_mat, this_missing_ld = distributed.load_ld_sharded(
                ld_schema_path, variants=variants, denylist=missing,
                ldthresh=args.ldthresh, mmap=args.mmap, dtype=dtype,
                mesh=mesh, u_dtype=u_dtype,
                cache_dir=args.factor_cache or None, plan=plan,
                n_total=n_pad)
            ld_cache[ld_key] = (ld_mat, this_missing_ld)
        else:
            ld_mat, this_missing_ld = load.load_ld_from_schema(
                ld_schema_path, variants=variants, denylist=missing,
                ldthresh=args.ldthresh, mmap=args.mmap, dtype=dtype,
                u_dtype=u_dtype, cache_dir=args.factor_cache or None)
            ld_cache[ld_key] = (ld_mat, this_missing_ld)
        combined_ld.append(ld_mat)
        missing_ld_info[this_missing_ld, idx] = True

    logging.info('Largest beta is... %f', np.max(np.abs(combined_betas)))
    betas = np.concatenate(combined_betas, axis=0)
    std_errs = np.concatenate(combined_errors, axis=0)

    if args.load_checkpoint:
        with open(args.load_checkpoint[1], 'rb') as pfile:
            cross_pop_covs = pickle.load(pfile)[0]
    else:
        logging.info('Building cross-population covariances...')
        mins, maxes = mixture.effect_size_ranges(betas, std_errs,
                                                 args.scaled)
        cross_pop_covs = mixture.make_simple(
            num_pops, args.components, mins, maxes,
            drop_non_psd=args.drop_non_psd)
        with open('%s.covariance.pkl' % args.output, 'wb') as ofile:
            pickle.dump([cross_pop_covs], ofile)

    out_index = None
    if multiproc:
        from vilma_tpu.parallel import alignment
        args.align_layout = False     # the loader controlled the layout
        if plan is not None:
            # LD was loaded directly into shard-local layout coordinates;
            # bring the per-SNP arrays along (host-side, identical on all
            # processes) — outputs restore original order via out_index
            betas = alignment.relayout_rows(betas, plan.layout_map,
                                            plan.L, fill=0.0)
            std_errs = alignment.relayout_rows(std_errs, plan.layout_map,
                                               plan.L, fill=1.0)
            annotations = alignment.relayout_annotations(
                annotations, plan.layout_map, plan.L)
            out_index = plan.layout_map
        elif n_pad is not None and n_pad > variants.shape[0]:
            # global-gather fallback: pad the SNP axis with inert slots
            # (beta 0 / SE 1 / zero annotation rows) so any extract-list
            # length shards evenly — no user-visible divisibility rule
            n_var = variants.shape[0]
            pad = n_pad - n_var
            betas = np.pad(betas, ((0, 0), (0, pad)))
            std_errs = np.pad(std_errs, ((0, 0), (0, pad)),
                              constant_values=1.0)
            annotations = np.pad(annotations, ((0, pad), (0, 0)))
            out_index = np.arange(n_var)
    if args.precision == 'f32' and not args.align_layout and not multiproc:
        # the f32 path takes the row-wise matvec gather/scatter, which
        # wants 128-aligned block spans; outputs are unchanged (inert
        # pads, original variant order restored)
        logging.info('Enabling --align-layout for the f32 path.')
        args.align_layout = True
    if mesh is not None and not args.align_layout and not multiproc:
        # the shard-local layout is what makes the sharded matvec
        # collective-free (blocks._dot_sharded); outputs are unchanged
        logging.info('Enabling --align-layout for the sharded path.')
        args.align_layout = True
    if args.align_layout:
        from vilma_tpu.parallel import alignment
        n_var = variants.shape[0]
        # under a mesh, plan shard-local spans so every device's matvec
        # touches only its own blocks (no per-evaluation collectives)
        n_shards = mesh.shape['snp'] if mesh is not None else 1
        layout_map, L, ok = alignment.compute_layout(combined_ld, n_var,
                                                     n_shards=n_shards)
        if ok:
            logging.info('Aligned layout: %d variants -> %d slots'
                         '%s', n_var, L,
                         f' ({n_shards} shard-local spans)'
                         if n_shards > 1 else '')
            from vilma_tpu.ops import blocks as blocks_mod
            spill = blocks_mod.FactorSpill() if args.mmap else None
            # memoize by identity: cohorts sharing one loaded LD panel
            # must keep sharing after the relayout, or the engine's
            # identity dedup (ModelData.ld_index) stops applying and
            # device memory doubles
            relayouted = {}
            for ld in combined_ld:
                if id(ld) not in relayouted:
                    relayouted[id(ld)] = alignment.relayout_ld(
                        ld, layout_map, L, dtype=dtype, spill=spill,
                        u_dtype=u_dtype, n_shards=n_shards)
            combined_ld = [relayouted[id(ld)] for ld in combined_ld]
            betas = alignment.relayout_rows(betas, layout_map, L, fill=0.0)
            std_errs = alignment.relayout_rows(std_errs, layout_map, L,
                                               fill=1.0)
            annotations = alignment.relayout_annotations(annotations,
                                                         layout_map, L)
            out_index = layout_map
        else:
            logging.warning('The LD schemas disagree on the relative '
                            'order of shared variants; skipping '
                            '--align-layout.')

    logging.info('Fitting...')
    from vilma_tpu.inference import MultiPopVI
    elbo = MultiPopVI(
        marginal_effects=betas.astype(dtype),
        std_errs=std_errs.astype(dtype),
        ld_mats=combined_ld,
        mixture_covs=cross_pop_covs,
        annotations=annotations,
        checkpoint=(args.checkpoint_freq > 0),
        checkpoint_freq=args.checkpoint_freq,
        output=args.output,
        scaled=args.scaled,
        scale_se=args.scale_se,
        gwas_N=gwas_n,
        init_hg=init_hg,
        num_its=args.num_its,
        dtype=dtype,
        mesh=mesh,
        out_index=out_index,
    )
    checkpoint = None
    if args.load_checkpoint:
        checkpoint = np.load(args.load_checkpoint[0])
    if args.profile:
        jax.profiler.start_trace(args.profile)
    state = elbo.optimize(checkpoint)
    if args.profile:
        jax.profiler.stop_trace()

    # every rank must run these (they all-gather sharded arrays in
    # multi-host runs); only the file writes belong to rank 0.
    # Genome-scale fits stream the [K, *, I]-shaped members (vi_mu,
    # vi_delta, vi_sigma) into the .npz in bounded chunks — with a
    # production mixture grid those arrays are tens of GB and a
    # materialized write would OOM the host (engine.dump_spec /
    # vi_sigma_chunks, utils/npz_stream.py)
    to_save, streams = elbo.dump_spec(state)
    posterior_means = elbo.real_posterior_mean(state)
    posterior_vars = elbo.real_posterior_variance(state)
    if args.save_vi_sigma:
        dtype_out = np.dtype(elbo.data.marginal_effects.dtype)
        streams = streams + [
            ('vi_sigma',
             (elbo.num_mix, elbo.num_pops, elbo.num_pops,
              elbo.num_loci), dtype_out, elbo.vi_sigma_chunks())]
    if jax.process_index() != 0:
        # multi-host: every rank joins the chunk computes (each fetch
        # all-gathers); rank 0 alone writes the files
        for _, _, _, chunk_iter in streams:
            for _ in chunk_iter:
                pass
        return
    from vilma_tpu.utils.npz_stream import save_npz_stream
    save_npz_stream(args.output, to_save, streams)

    columns = {name: variants[name] for name in load.VARIANT_COLUMNS}
    for name, posterior in zip(names, posterior_means):
        columns['posterior_' + name] = posterior
    for name, pmv in zip(names, posterior_vars):
        columns['posterior_variance_' + name] = pmv
    if args.annotations:
        columns['missing_annotation'] = missing_annot
    for idx, name in enumerate(names):
        columns['missing_sumstats_' + name] = missing_sumstats[:, idx]
        columns['missing_LD_' + name] = missing_ld_info[:, idx]
    table.write_tsv(args.output + '.estimates.tsv', columns)


def _resolve_precision(precision):
    """Resolve --precision auto from the backend JAX runs on (this
    initializes the backend, in this process): f32 on a GPU, f64
    elsewhere. An explicit f32/f64 choice is honored as given."""
    if precision != 'auto':
        return precision
    import jax
    backend = jax.default_backend()
    if backend == 'gpu':
        logging.info('Selected --precision f32 (GPU backend; pass '
                     '--precision f64 for the parity path).')
        return 'f32'
    logging.info('Selected --precision f64 (%s backend).', backend)
    return 'f64'


def _configure_precision(precision):
    """f64 enables x64 on whatever backend JAX runs (the GPU computes
    float64 natively). f32 keeps JAX's matmul precision: on a GPU an f32
    contraction may run in TF32, and a 100K-SNP fit held that way to the
    f32 drift bounds of tests/test_f32_genome_scale.py, with its
    posterior means within 2e-4 sd of float64's (PERF.md). Set
    JAX_DEFAULT_MATMUL_PRECISION=highest for full-f32 products."""
    import jax
    if precision == 'f64':
        jax.config.update('jax_enable_x64', True)
    logging.info('Precision %s: x64 %s, default matmul precision %s',
                 precision, jax.config.jax_enable_x64,
                 jax.config.jax_default_matmul_precision)
