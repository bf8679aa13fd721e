"""Genome-scale (1M-SNP) f32 / bf16-LD drift evidence vs the f64 path.

Extends tests/test_f32_genome_scale.py's statistical methodology to the
1M-SNP configuration: f32/bf16 accuracy evidence at genome scale, not
only at 100K.

Each leg runs in its own process (the backend/x64 choice binds at
startup); the f32 and bf16 legs run on the default device (a GPU):

    python tools/drift_genome.py --leg f64cpu --out /tmp/d64.npz
    python tools/drift_genome.py --leg f32 --out /tmp/d32.npz
    python tools/drift_genome.py --leg bf16 --out /tmp/dbf.npz
    python tools/drift_genome.py --compare /tmp/d64.npz /tmp/d32.npz
    python tools/drift_genome.py --compare /tmp/d64.npz /tmp/dbf.npz

All legs fit the SAME synthetic 1M-SNP 2-cohort problem (bench.py's
generator, seed-pinned) with the compact state for ITERS outer
iterations and save posterior means/SDs + ELBO telemetry. --compare
prints the statistical drift report:

 * accumulated-vs-recomputed ELBO (pure accumulator cancellation);
 * posterior-mean drift in posterior-SD units (quantiles) — coordinate
   ascent is not contractive per SNP, so the two precisions follow
   different, equally valid ascent paths and agreement is statistical;
 * objective quality: relative difference of the recomputed ELBOs;
 * the reference's two convergence tests evaluated each iteration.
"""
import argparse
import functools
import json
import os
import sys
import time

import numpy as np

# bench.py lives at the repo root (one level up from tools/)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

print = functools.partial(print, flush=True)  # noqa: A001

ITERS = 40


def run_leg(leg, out_path):
    import os
    if leg == 'f64cpu':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
        dtype = np.float64
    else:
        if leg == 'bf16':
            os.environ['BENCH_LD_DTYPE'] = 'bf16'
        dtype = np.float32
    os.environ.setdefault('BENCH_SIZE', '1m')

    import jax
    import bench
    from vilma_tpu.inference import engine
    from vilma_tpu.utils.cache import configure_compile_cache

    configure_compile_cache()
    device = jax.devices()[0]
    if leg != 'f64cpu':
        assert device.platform == 'gpu', f'leg {leg} needs a GPU'
    print(f'leg={leg} device={device} dtype={dtype.__name__} '
          f'loci={bench.NUM_LOCI}')
    data, st = bench._build(dtype, device)

    step = jax.jit(functools.partial(engine.outer_step_impl,
                                     line_search_rate=2.0))
    conv = []
    post_prev = None
    t0 = time.perf_counter()
    for it in range(ITERS):
        st, _ = step(data, st)
        m = engine.materialize_state(data, st)
        pm = np.asarray(engine.posterior_mean(m.vi_mu, m.vi_delta))
        red = float(st.running_elbo_delta)
        c = (post_prev is not None
             and np.allclose(pm, post_prev, atol=engine.ABS_TOL,
                             rtol=engine.REL_TOL)
             or np.isclose(red, 0, atol=engine.ELBO_TOL, rtol=0))
        conv.append(bool(c))
        post_prev = pm
        if it % 10 == 0:
            print(f'  it {it}: elbo={float(st.elbo):.3f} '
                  f'({time.perf_counter() - t0:.0f}s)')

    m = engine.materialize_state(data, st)
    post = np.asarray(engine.posterior_mean(m.vi_mu, m.vi_delta))
    pmv = np.asarray(engine.posterior_marginal_variance(
        engine.posterior_mean(m.vi_mu, m.vi_delta), m.vi_mu, m.vi_delta,
        m.sigma))
    acc = float(st.elbo)
    true = float(engine.elbo_jit(data, m.sigma, m.error_scaling, m.vi_mu,
                                 m.vi_delta, m.hyper_delta))
    np.savez(out_path, leg=leg, post=post, pmv=pmv, acc=acc, true=true,
             conv=np.asarray(conv))
    print(f'saved {out_path}: acc={acc:.4f} true={true:.4f} '
          f'({time.perf_counter() - t0:.0f}s total)')


def compare(base_path, test_path):
    b = np.load(base_path, allow_pickle=True)
    t = np.load(test_path, allow_pickle=True)
    sd = np.sqrt(np.maximum(b['pmv'], 0))
    rel = np.abs(t['post'] - b['post']) / np.maximum(sd, 1e-12)
    scale = np.abs(b['post']).max()
    med = float(np.median(np.abs(t['post'] - b['post']))) / scale
    conv_b = np.asarray(b['conv'])
    conv_t = np.asarray(t['conv'])
    fb = int(np.argmax(conv_b)) if conv_b.any() else -1
    ft = int(np.argmax(conv_t)) if conv_t.any() else -1
    rep = {
        'base': str(b['leg']), 'test': str(t['leg']), 'iters': ITERS,
        'elbo_accumulator_drift_base':
            abs(float(b['acc']) - float(b['true'])) / abs(float(b['true'])),
        'elbo_accumulator_drift_test':
            abs(float(t['acc']) - float(t['true'])) / abs(float(t['true'])),
        'recomputed_elbo_rel_diff':
            abs(float(t['true']) - float(b['true'])) / abs(float(b['true'])),
        'post_sd_units_q999': float(np.quantile(rel, 0.999)),
        'post_sd_units_frac_gt3': float(np.mean(rel > 3.0)),
        'post_median_absdiff_rel_scale': med,
        'first_convergence_iter': [fb, ft],
    }
    print(json.dumps(rep, indent=2))
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--leg', choices=['f64cpu', 'f32', 'bf16'])
    ap.add_argument('--out')
    ap.add_argument('--compare', nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    elif args.leg:
        assert args.out
        run_leg(args.leg, args.out)
    else:
        ap.error('need --leg/--out or --compare')


if __name__ == '__main__':
    sys.exit(main())
