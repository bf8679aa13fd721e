"""LD-panel build benchmark: `make_ld_schema` throughput.

The reference builds LD panels by streaming PLINK genotypes through
plinkio and computing one NaN-aware pairwise correlation matrix per
block with `pandas.DataFrame.corr()` plus an eigh truncation
(reference make_ld_schema.py:68-93) — the corr is the O(n_block^2 *
samples) hot spot. plinkio is not installed here, so the measurable
anchor is that exact per-block mechanism (pandas .corr() + eigh) on
identical genotype blocks, versus this repo's end-to-end
`make_ld_schema` (C++/numpy 2-bit decode + GEMM-based NaN-aware
correlation + eigh + schema writes — vilma_tpu/commands/
make_ld_schema.py). Byte-level output parity with the reference is
pinned separately by tests/test_cli.py's goldens; this records speed.

Run: python bench_ld_build.py [n_blocks [block_size [n_samples]]]
CPU-only.
"""
import os
import sys
import tempfile
import time

import numpy as np


def synth_plink(outdir, n_blocks, block, n_samples, missing=0.02,
                seed=0):
    """Write synthetic .bed/.bim/.fam + a UCSC blocks file."""
    rng = np.random.default_rng(seed)
    n_snps = n_blocks * block
    base = os.path.join(outdir, 'synth')
    # genotypes with LD: per block, a latent AR(1) signal thresholded
    # into 0/1/2 dosages; ~missing fraction set to the missing code
    genos = np.empty((n_snps, n_samples), dtype=np.int8)
    for b in range(n_blocks):
        z = rng.standard_normal((block + 32, n_samples))
        for i in range(1, z.shape[0]):
            z[i] = 0.9 * z[i - 1] + np.sqrt(1 - 0.81) * z[i]
        z = z[32:]
        # threshold the latent signal into 0/1/2 dosages at per-SNP
        # frequency-dependent cuts (row-wise quantiles)
        freq = rng.uniform(0.1, 0.5, block)
        q1 = np.quantile(z, 0.5, axis=1, keepdims=True)
        q2 = np.array([np.quantile(z[i], min(0.5 + freq[i] / 2, 0.99))
                       for i in range(block)])[:, None]
        g = ((z > q1).astype(np.int8) + (z > q2).astype(np.int8))
        genos[b * block:(b + 1) * block] = g
    miss_mask = rng.random(genos.shape) < missing
    # PLINK 1.9 .bed codes (2-bit, SNP-major): 00=hom alt(2), 01=missing,
    # 10=het(1), 11=hom ref(0)
    code = np.where(genos == 2, 0b00,
                    np.where(genos == 1, 0b10, 0b11)).astype(np.uint8)
    code[miss_mask] = 0b01
    n_bytes = -(-n_samples // 4)
    with open(base + '.bed', 'wb') as fh:
        fh.write(bytes([0x6c, 0x1b, 0x01]))
        padded = np.zeros((n_snps, n_bytes * 4), dtype=np.uint8)
        padded[:, :n_samples] = code
        packed = (padded[:, 0::4] | (padded[:, 1::4] << 2)
                  | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6))
        fh.write(packed.astype(np.uint8).tobytes())
    with open(base + '.bim', 'w') as fh:
        for i in range(n_snps):
            fh.write(f'1\tsnp{i}\t0\t{i + 1}\tA\tT\n')
    with open(base + '.fam', 'w') as fh:
        for s in range(n_samples):
            fh.write(f'f{s}\ti{s}\t0\t0\t1\t-9\n')
    with open(base + '.blocks.bed', 'w') as fh:
        for b in range(n_blocks):
            fh.write(f'1\t{b * block}\t{(b + 1) * block}\n')
    with open(base + '.list', 'w') as fh:
        fh.write(base + '\n')
    # float genotypes with NaN for the reference-mechanism anchor
    gf = genos.astype(np.float64)
    gf[miss_mask] = np.nan
    return base, gf


def time_ours(base, outdir, ldthresh=0.99):
    from types import SimpleNamespace
    from vilma_tpu.commands import make_ld_schema
    args = SimpleNamespace(
        logfile='', verbose=False,
        out_root=os.path.join(outdir, 'ours', 'schema'),
        block_file=base + '.blocks.bed',
        plink_file_list=base + '.list',
        extract='', ldthresh=ldthresh)
    os.makedirs(os.path.dirname(args.out_root), exist_ok=True)
    t0 = time.perf_counter()
    make_ld_schema.main(args)
    return time.perf_counter() - t0


def time_reference_mechanism(gf, n_blocks, block, ldthresh=0.99):
    """The reference's per-block hot loop on the same genotypes:
    pandas NaN-aware pairwise corr + the eigh truncation
    (make_ld_schema.py:78-83 mechanism; excludes decode + file IO,
    so it is a LOWER bound on the reference's wall time)."""
    import pandas as pd
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), 'tests'))
    import reference_oracle
    reference_oracle.install()
    from vilma.matrix_structures import LowRankMatrix
    t0 = time.perf_counter()
    for b in range(n_blocks):
        g = gf[b * block:(b + 1) * block]
        mat = pd.DataFrame(g.T).corr().values
        LowRankMatrix(X=mat, t=ldthresh)
    return time.perf_counter() - t0


def main():
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    n_samples = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    outdir = tempfile.mkdtemp(prefix='ld_build_bench_')
    print(f'{n_blocks} blocks x {block} SNPs, {n_samples} samples')
    base, gf = synth_plink(outdir, n_blocks, block, n_samples)
    ours = time_ours(base, outdir)
    ref = time_reference_mechanism(gf, n_blocks, block)
    n_snps = n_blocks * block
    print(f'vilma_tpu make_ld_schema (end-to-end): {ours:8.2f} s '
          f'({n_snps / ours:,.0f} SNPs/s)')
    print(f'reference corr+eigh mechanism only:    {ref:8.2f} s '
          f'({n_snps / ref:,.0f} SNPs/s)')
    print(f'ratio (>= reference end-to-end gain):  {ref / ours:8.1f}x')


if __name__ == '__main__':
    main()
