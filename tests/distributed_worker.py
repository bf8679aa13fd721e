"""Worker process for the multi-host equivalence test.

Launched by tests/test_distributed.py: N of these form a jax.distributed
CPU cluster (several simulated devices each), load the LD schema with
per-process block ownership (parallel.distributed.load_ld_sharded), run a
full MultiPopVI fit under the global mesh, and compare the posterior
means against the single-process golden the parent computed.

By default the worker exercises the SHARD-LOCAL layout (the production
multi-host path: plan_sharded_load + collective-free shard_map matvecs)
and asserts both `shard_count > 1` and that the compiled outer step
contains no O(I) collectives. Pass layout=gather as the 7th argument to
exercise the global-gather fallback instead.

Usage: distributed_worker.py <pid> <nproc> <port> <schema> <expected.npy>
       [devices_per_process] [layout] [model]

model=scale_se runs a --learn-scaling fit (the per-component compact
[K, P, I] natural-mean state sharded over the mesh).
"""
import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    schema, expected_path = sys.argv[4], sys.argv[5]
    n_dev = int(sys.argv[6]) if len(sys.argv) > 6 else 4
    layout = sys.argv[7] if len(sys.argv) > 7 else 'shard-local'
    scale_se = (sys.argv[8] if len(sys.argv) > 8 else '') == 'scale_se'

    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['XLA_FLAGS'] = (
        os.environ.get('XLA_FLAGS', '')
        + f' --xla_force_host_platform_device_count={n_dev}')
    import jax
    # force CPU before any backend or coordination-service use
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    jax.distributed.initialize(coordinator_address=f'localhost:{port}',
                               num_processes=nproc, process_id=pid)

    import numpy as np
    import pandas as pd
    from jax.sharding import Mesh
    from vilma_tpu.parallel import alignment, distributed
    from vilma_tpu.inference import MultiPopVI, engine

    assert jax.process_count() == nproc
    devices = distributed.process_contiguous_devices()
    mesh = Mesh(np.asarray(devices).reshape(1, len(devices)),
                axis_names=('comp', 'snp'))

    variants = pd.read_csv(schema + '.extract', sep='\t')
    np.random.seed(0)
    n = variants.shape[0]
    rng = np.random.default_rng(1)
    std_errs = rng.uniform(0.01, 0.05, (2, n))
    betas = rng.standard_normal((2, n)) * std_errs * 2
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.ones((n, 1))

    out_index = None
    if layout == 'shard-local':
        plan = distributed.plan_sharded_load(
            [(schema, []), (schema, [])], variants, len(devices))
        assert plan is not None, 'blocks should be contiguous here'
        ld, missing = distributed.load_ld_sharded(
            schema, variants, denylist=[], ldthresh=1.0, mesh=mesh,
            plan=plan)
        assert ld.shard_count == len(devices), ld.shard_count
        assert ld.row_aligned
        betas = alignment.relayout_rows(betas, plan.layout_map, plan.L,
                                        fill=0.0)
        std_errs = alignment.relayout_rows(std_errs, plan.layout_map,
                                           plan.L, fill=1.0)
        annotations = alignment.relayout_annotations(
            annotations, plan.layout_map, plan.L)
        out_index = plan.layout_map
    else:
        ld, missing = distributed.load_ld_sharded(
            schema, variants, denylist=[], ldthresh=1.0, mesh=mesh)

    vi = MultiPopVI(marginal_effects=betas, std_errs=std_errs,
                    ld_mats=[ld, ld], annotations=annotations,
                    mixture_covs=covs, checkpoint=False,
                    gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
                    num_its=15 if scale_se else 5, mesh=mesh,
                    out_index=out_index, scale_se=scale_se)

    vi.optimize()
    got = vi.real_posterior_mean()

    if layout == 'shard-local':
        # the production claim: one outer step's cross-device traffic is
        # a handful of small (I-independent) all-reduces — no O(I)
        # all-gathers from the genome<->block permutation. (Checked after
        # optimize so the HLO probe cannot disturb the seeded RNG stream
        # the golden initialization consumed.)
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from analyze_collectives import collective_inventory
        with jax.set_mesh(mesh):
            hlo = jax.jit(
                lambda d, s: engine.outer_step_impl(d, s, 2.0),
            ).lower(vi.data, vi.state).compile().as_text()
        inv = collective_inventory(hlo)
        bad = {op: v for op, v in inv.items() if op != 'all-reduce'}
        assert not bad, f'non-all-reduce collectives in the step: {bad}'
        # scalar/[A,K] reductions only: an O(I) term would be >= I*8 B
        # (4 KB at I=512); the shard-local budget is a few hundred bytes
        ar_bytes = inv.get('all-reduce', (0, 0))[1]
        assert ar_bytes < 2048, (
            f'all-reduce payload scales with I: {ar_bytes} bytes')

    expected = np.load(expected_path)
    max_diff = float(np.max(np.abs(got - expected)))
    denom = np.maximum(np.abs(expected), 1e-12)
    max_rel = float(np.max(np.abs(got - expected) / denom))
    if np.allclose(got, expected, rtol=1e-8, atol=1e-10):
        print(f'OK pid={pid} layout={layout} max_diff={max_diff:.3e} '
              f'max_rel={max_rel:.3e}')
    else:
        print(f'MISMATCH pid={pid} layout={layout} '
              f'max_diff={max_diff:.3e} max_rel={max_rel:.3e}')
        sys.exit(1)


if __name__ == '__main__':
    main()
