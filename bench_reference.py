"""One-time honest-baseline measurement: the ACTUAL reference engine
(jeffspence/vilma, imported in-process from /root/reference) timed per
coordinate-ascent iteration on the same synthetic problem family as
bench.py, next to this repo's engine on the host CPU in f64.

Caveat recorded in BASELINE.md: numba is not installed in this
environment (and installs are forbidden), so the reference runs through
the no-op-njit shim (tests/reference_oracle.py) — its kernels execute as
pure-Python loops, a strict LOWER bound on real numba throughput. The
repo's own CPU-f64 jitted run is the upper anchor (XLA is at least as
fast as numba-compiled loops on the same hardware). Real numba vilma
lies between the two anchors.

Usage: python bench_reference.py [sizes...]   (defaults: 1024 4096)
CPU-only.
"""
import sys
import time

import numpy as np


def _problem(num_loci, num_components=18, block_size=1024, rank_frac=0.5):
    rng = np.random.default_rng(0)
    dense_blocks, indices = [], []
    start = 0
    while start < num_loci:
        n = min(block_size, num_loci - start)
        rho = rng.uniform(0.3, 0.95)
        idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        dense_blocks.append(rho ** idx)
        indices.append(np.arange(start, start + n))
        start += n
    rng = np.random.default_rng(1)
    P = 2
    std_errs = rng.uniform(0.01, 0.05, (P, num_loci))
    betas = rng.standard_normal((P, num_loci)) * std_errs * 2
    scales = np.exp(np.linspace(np.log(1e-6), np.log(1e-2),
                                num_components))
    covs = []
    for k in range(num_components):
        a = rng.standard_normal((P, P))
        corr = 0.3 * (a @ a.T) + P * np.eye(P)
        d = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(d, d)))
    annotations = np.zeros((num_loci, 4), dtype=int)
    annotations[np.arange(num_loci), rng.integers(0, 4, num_loci)] = 1
    kwargs = dict(marginal_effects=betas, std_errs=std_errs,
                  mixture_covs=covs, annotations=annotations,
                  checkpoint=False, checkpoint_freq=-1, scaled=False,
                  scale_se=False, gwas_N=np.full(P, 1e5),
                  init_hg=np.full(P, 0.3), num_its=100)
    return dense_blocks, indices, kwargs


def time_reference(num_loci, n_steps=2):
    sys.path.insert(0, 'tests')
    import reference_oracle
    reference_oracle.install()
    from vilma import matrix_structures as ref_ms
    from vilma.variational_inference import MultiPopVI as RefVI

    dense_blocks, indices, kwargs = _problem(num_loci)
    # rank_frac=0.5 truncation to match bench.py's LD
    mats = []
    for blk in dense_blocks:
        m = ref_ms.LowRankMatrix(X=blk, t=1.0)
        r = max(1, m.s.shape[0] // 2)
        order = np.argsort(m.s)[::-1][:r]
        mats.append(ref_ms.LowRankMatrix(
            u=np.ascontiguousarray(m.u[:, order]), s=m.s[order],
            v=np.ascontiguousarray(m.v[order]), D=m.D))
    ld = ref_ms.BlockDiagonalMatrix(mats)
    np.random.seed(5)
    vi = RefVI(ld_mats=[ld, ld], output='/tmp/ref_bench', **kwargs)
    params = vi._initialize()
    elbo = vi.elbo(params)
    L = np.ones(5)
    red = None
    # one unmeasured step to move off the init point
    params, L, elbo, red = vi._optimize_step(params, L=L, curr_elbo=elbo,
                                             line_search_rate=2.,
                                             running_elbo_delta=red)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, L, elbo, red = vi._optimize_step(
            params, L=L, curr_elbo=elbo, line_search_rate=2.,
            running_elbo_delta=red)
    dt = (time.perf_counter() - t0) / n_steps
    return dt


def time_mine(num_loci, n_steps=5):
    import jax
    jax.config.update('jax_enable_x64', True)
    jax.config.update('jax_platforms', 'cpu')
    from vilma_tpu.ops import blocks, lowrank
    from vilma_tpu.inference import engine
    from vilma_tpu.utils import synthetic

    dense_blocks, indices, kwargs = _problem(num_loci)
    factors = []
    for blk in dense_blocks:
        f = lowrank.factor_block(X=blk, t=1.0, check_symmetric=False)
        r = max(1, f.r // 2)
        order = np.argsort(f.s)[::-1][:r]
        factors.append(lowrank.LowRankFactor(
            u=np.ascontiguousarray(f.u[:, order]), s=f.s[order], d=f.d,
            rank=int(r)))
    ld = blocks.pack(factors, indices, num_loci)
    data = engine.build_model_data(
        kwargs['marginal_effects'], kwargs['std_errs'], [ld, ld],
        kwargs['annotations'], kwargs['mixture_covs'], scaled=False,
        scale_se=False, gwas_N=kwargs['gwas_N'],
        init_hg=kwargs['init_hg'])
    st = synthetic.synthetic_state(data)
    st, _ = engine.outer_step(data, st, line_search_rate=2.0)  # compile
    float(st.elbo)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        st, _ = engine.outer_step(data, st, line_search_rate=2.0)
    float(st.elbo)
    return (time.perf_counter() - t0) / n_steps


def main():
    sizes = [int(s) for s in sys.argv[1:]] or [1024, 4096]
    print(f'{"SNPs":>8} {"ref (no-numba) s/iter":>22} '
          f'{"vilma_tpu CPU-f64 s/iter":>25} {"ratio":>7}')
    for n in sizes:
        mine = time_mine(n)
        ref = time_reference(n)
        print(f'{n:>8} {ref:>22.3f} {mine:>25.4f} {ref / mine:>7.1f}')


if __name__ == '__main__':
    main()
