#!/usr/bin/env python3
"""Smoke test of vilma-tpu on one NVIDIA GPU.

    python chip_smoke.py               # one GPU: the 1M-SNP fit
    python chip_smoke.py --parity      # one GPU: f32 against f64 only
    python chip_smoke.py --four-cards  # four GPUs: the sharded fits only

Phases, in order (each prints its own lines and seconds):

  device     JAX's devices, the card's name and power limit; fails
             unless JAX runs on a GPU.
  gen        the inputs, written to disk from --seed: 1M SNPs x 2 cohorts
             sharing one LD panel (no download); 100K with --parity or
             --four-cards.
  fit        `vilma-tpu fit` on them with the CLI's -K 12 grid,
             --learn-scaling, bf16 LD: setup and per-iteration seconds,
             compile seconds, the ELBO trace, peak device memory, the
             output files. Then, on the fitted problem, one objective
             evaluation split into prologue and LD matvec, also for a
             K=18 grid.
  gpu-tests  `pytest -m gpu` on the card (the LD matvec at genome-scale
             bucket shapes against float64 numpy; f64 and f32 fit steps).

--parity runs device, gen and parity: the 100K inputs fitted with
--precision f64, with --precision f32 as `fit` runs it (TF32 products
allowed on the GPU), and with --precision f32 at HIGHEST products (a
reading), each f32 fit held to the f32 drift bounds of
tests/test_f32_genome_scale.py. Three cold compiles of the fit make it
too long for the default run.

--four-cards runs device, gen and four: the 100K inputs fitted on one
GPU and with --mesh snp=4 (one process, one fit after the other), then
with --distributed --mesh snp=4 as four processes each bound to its own
GPU; posterior means against the 1-GPU fit, and the collectives of the
sharded outer step. Each fit compiles cold for 3-4 min on an H100, so
the run takes about 12 min.

The parent process never imports JAX: every phase runs in a child, one
at a time, so one process holds the card at any moment. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}. Any
failed phase exits non-zero before it.
"""
import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, '.smoke_work')

FIT_1M = 1_000_000
FIT_100K = 100_000   # the parity and four-card inputs
FIT_ITS = 3          # outer iterations of the 1M-SNP and four-card fits
PARITY_ITS = 50
# (name, environment) of the --precision f32 parity fits; the first is
# what `fit --precision f32` runs (JAX's default matmul precision, which
# allows TF32 products on the GPU) and decides the phase, the others are
# readings
PARITY_F32 = (('f32', {}),
              ('f32 highest', {'JAX_DEFAULT_MATMUL_PRECISION': 'highest'}))
# the sharded fits sum in another order than the 1-GPU fit: f32
# reassociation over a few iterations
SHARDED_TOL = 1e-4


def num_snps(args):
    """SNP count of this run's inputs."""
    return FIT_100K if args.parity or args.four_cards else FIT_1M


def say(*parts):
    print(*parts, flush=True)


def smi():
    """nvidia-smi's name,power.limit line for each card (no JAX)."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f'nvidia-smi unavailable: {err}'


# ---------------------------------------------------------------------------
# inputs written from the seed (no download)
# ---------------------------------------------------------------------------

def block_sizes(num_loci, seed):
    """LDetect-like block sizes: lognormal around 560 SNPs (mean ~620),
    clipped to [256, 1536]; the last block takes the remainder."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes, total = [], 0
    while total < num_loci:
        n = int(np.clip(round(np.exp(rng.normal(np.log(560), 0.45))),
                        256, 1536))
        n = min(n, num_loci - total)
        sizes.append(n)
        total += n
    return sizes


def block_spectrum(n):
    """Half-rank spectrum summing to n (trace of a correlation block),
    decaying e-fold every third of the rank; all values exceed the
    1 - sqrt(0.8) cut of --ldthresh 0.8."""
    import numpy as np
    k = max(1, n // 2)
    decay = np.exp(-3.0 * np.arange(k) / k)
    return decay * (n / decay.sum())


def write_inputs(root, num_loci, seed, num_pops=2):
    """One LD schema (stacked eigendecompositions in f32), an extract
    list and num_pops sumstats files simulated from the LD panel."""
    import numpy as np
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    ids = np.array([f'snp{i}' for i in range(num_loci)])
    manifest, start = [], 0
    beta_hat = np.zeros((num_pops, num_loci))
    se = rng.uniform(0.01, 0.05, (num_pops, num_loci))
    causal = rng.random(num_loci) < 0.01
    shared = rng.standard_normal(num_loci)
    true = np.stack([causal * (0.8 * shared + 0.6 * rng.standard_normal(
        num_loci)) * 0.02 for _ in range(num_pops)])
    for b, n in enumerate(block_sizes(num_loci, seed)):
        s = block_spectrum(n)
        q, _ = np.linalg.qr(rng.standard_normal((n, s.size),
                                                dtype=np.float32))
        base = f'panel_1:{b}'
        np.save(os.path.join(root, base + '.npy'),
                np.vstack([q, s[None, :]]).astype(np.float32))
        with open(os.path.join(root, base + '.var'), 'w') as fh:
            fh.write(''.join(f'{ids[start + i]}\t1\t{start + i + 1}\t0.0'
                             f'\tA\tG\n' for i in range(n)))
        manifest.append(f'{base}.var\t{base}.npy')
        sl = slice(start, start + n)
        for p in range(num_pops):
            z = true[p, sl] / se[p, sl]
            noise = q @ (np.sqrt(s) * rng.standard_normal(s.size,
                                                          np.float32))
            beta_hat[p, sl] = se[p, sl] * (q @ (s * (q.T @ z)) + noise)
        start += n
    with open(os.path.join(root, 'panel.schema'), 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')
    with open(os.path.join(root, 'extract.tsv'), 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.write(''.join(f'{i}\tA\tG\n' for i in ids))
    for p in range(num_pops):
        with open(os.path.join(root, f'pop{p + 1}.sumstats.tsv'), 'w') as fh:
            fh.write('ID\tA1\tA2\tBETA\tSE\n')
            fh.write(''.join(f'{i}\tA\tG\t{b:.8e}\t{e:.8e}\n' for i, b, e
                             in zip(ids, beta_hat[p], se[p])))
    return len(manifest)


def fit_argv(root, output, num_its, extra=()):
    schema = os.path.join(root, 'panel.schema')
    return ['fit', '--ld-schema', f'{schema},{schema}',
            '--sumstats', ','.join(os.path.join(root, f'pop{p}.sumstats.tsv')
                                   for p in (1, 2)),
            '--extract', os.path.join(root, 'extract.tsv'),
            '--names', 'pop1,pop2', '--output', output,
            '--samplesizes', '1e5,1e5', '--init-hg', '0.3,0.3',
            '--ldthresh', '0.8', '--seed', '42',
            '--num-its', str(num_its),
            '--factor-cache', os.path.join(root, 'factor_cache'),
            *extra]


def read_estimates(path):
    """{column: array} of the float columns of an .estimates.tsv (the
    parent reads it without importing the package, which imports JAX)."""
    import numpy as np
    with open(path) as fh:
        names = fh.readline().split()
        rows = [line.split() for line in fh]
    out = {}
    for j, name in enumerate(names):
        if name.startswith('posterior'):
            out[name] = np.array([r[j] for r in rows], dtype=np.float64)
    out['n'] = len(rows)
    return out


# ---------------------------------------------------------------------------
# child phases (each runs in its own process)
# ---------------------------------------------------------------------------

def _jax():
    sys.path.insert(0, HERE)
    from vilma_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    import jax
    return jax


def _timeit(fn, *args, reps=5):
    """Median seconds of fn(*args) after one warm-up call, each ended by
    block_until_ready."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def phase_device(args):
    jax = _jax()
    devs = jax.devices()
    d = devs[0]
    say(f'jax {jax.__version__} devices: {devs}')
    say(f'platform={d.platform} device_kind={d.device_kind} '
        f'count={len(devs)}')
    say(f'nvidia-smi name,power.limit: {smi()}')
    if d.platform != 'gpu':
        say('FAIL: JAX found no GPU')
        return 1
    with open(os.path.join(args.work, 'device.json'), 'w') as fh:
        json.dump({'platform': d.platform, 'kind': d.device_kind,
                   'count': len(devs)}, fh)
    return 0


def phase_gen(args):
    num_loci = num_snps(args)
    root = os.path.join(args.work, 'in')
    t = time.perf_counter()
    nb = write_inputs(root, num_loci, args.seed)
    du = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    say(f'generated {num_loci} SNPs, {nb} LD blocks, {du / 1e9:.3f} GB '
        f'in {time.perf_counter() - t:.1f} s (seed {args.seed})')
    return 0


class _LogClock:
    """Logging handler that keeps (seconds, message) of every record."""

    def __init__(self):
        import logging
        self.records = []
        self.t0 = time.perf_counter()
        outer = self

        class H(logging.Handler):
            def emit(self, record):
                outer.records.append((time.perf_counter() - outer.t0,
                                      record.getMessage()))

        root = logging.getLogger()
        root.setLevel(logging.INFO)
        root.addHandler(H())
        loud = logging.StreamHandler(sys.stderr)
        loud.setLevel(logging.WARNING)
        root.addHandler(loud)
        # JAX logs each compilation's seconds at DEBUG; its own stderr
        # handler keeps to warnings
        logging.getLogger('jax._src.dispatch').setLevel(logging.DEBUG)
        for handler in logging.getLogger('jax').handlers:
            handler.setLevel(logging.WARNING)

    def stage_seconds(self, stage):
        """[(seconds, program)] of every `stage` JAX logged: 'XLA
        compilation', 'tracing + transforming' or 'jaxpr to MLIR module
        conversion'."""
        out = []
        for _, m in self.all('^Finished ' + re.escape(stage)):
            g = re.match(r'Finished (?:tracing \+ transforming|jaxpr to MLIR '
                         r'module conversion|XLA compilation of) (.*?)'
                         r'(?: for pjit)? in (\S+) sec', m)
            if g:
                out.append((float(g.group(2)), g.group(1)))
        return out

    def first(self, pattern):
        for t, msg in self.records:
            if re.search(pattern, msg):
                return t
        raise RuntimeError(f'no log line matched {pattern!r}')

    def all(self, pattern):
        return [(t, m) for t, m in self.records if re.search(pattern, m)]


def _capture_fits():
    """Record every MultiPopVI that optimize() runs on."""
    from vilma_tpu.inference import engine
    fits = []
    orig = engine.MultiPopVI.optimize

    def optimize(self, *a, **k):
        fits.append(self)
        return orig(self, *a, **k)

    engine.MultiPopVI.optimize = optimize
    return fits


def phase_fit(args):
    jax = _jax()
    import numpy as np
    from vilma_tpu import frontend

    card = smi()
    root = os.path.join(args.work, 'in')
    out = os.path.join(args.work, 'fit_1m')
    clock = _LogClock()
    fits = _capture_fits()
    argv = fit_argv(root, out, FIT_ITS,
                    ['--learn-scaling', '--ld-precision', 'bf16',
                     '--no-save-vi-sigma'])
    say('vilma-tpu ' + ' '.join(argv))
    t0 = time.perf_counter()
    frontend.main(argv)
    wall = time.perf_counter() - t0
    t_ld = clock.first(r'Loading LD for population 1')
    t_cov = clock.first(r'Building cross-population covariances')
    t_fit = clock.first(r'^Fitting')
    its = clock.all(r'^Completed iteration')
    t_done = clock.first(r'^Optimization ran')
    elbos = [float(re.search(r'ELBO = (\S+),', m).group(1))
             for _, m in clock.all(r'^ELBO = ')]
    steps = np.diff([t for t, _ in its])
    say(f'[{card}]')
    say(f'  sumstats + extract load: {t_ld:.2f} s')
    say(f'  LD load + eigh (2 cohorts, 1 shared panel): '
        f'{t_cov - t_ld:.2f} s')
    say(f'  h2d + precompute + compile + first iteration: '
        f'{its[0][0] - t_fit:.2f} s')
    say(f'  per-iteration seconds (iterations 2..): '
        f'{[round(float(x), 4) for x in steps]}')
    say(f'  output writing: {wall - t_done:.2f} s; total {wall:.2f} s')
    for stage in ('tracing + transforming', 'jaxpr to MLIR module conversion',
                  'XLA compilation'):
        rec = clock.stage_seconds(stage)
        say(f'  {stage} (nested programs overlap): '
            f'{sum(t for t, _ in rec):.1f} s over {len(rec)} '
            f'programs; largest: ' + ', '.join(
                f'{n} {t:.1f} s' for t, n in sorted(rec)[::-1][:4]))
    say(f'  ELBO trace: {elbos}')
    stats = jax.devices()[0].memory_stats() or {}
    say(f'  peak_bytes_in_use: {stats.get("peak_bytes_in_use")}')
    for suffix in ('.npz', '.covariance.pkl', '.estimates.tsv'):
        path = out + suffix
        say(f'  output {os.path.basename(path)}: '
            f'{os.path.getsize(path)} bytes')
    est = read_estimates(out + '.estimates.tsv')
    pm = np.stack([est['posterior_pop1'], est['posterior_pop2']])
    if est['n'] != FIT_1M or not np.all(np.isfinite(pm)):
        say('FAIL: estimates are not finite values for every SNP')
        return 1
    if not np.all(np.isfinite(elbos)):
        say('FAIL: non-finite ELBO')
        return 1
    drops = [b - a for a, b in zip(elbos, elbos[1:]) if b < a]
    if drops and min(drops) < -1e-6 * abs(elbos[-1]):
        say(f'FAIL: the ELBO fell: {drops}')
        return 1
    return _measure_fitted(jax, fits[-1], card, args)


def _measure_fitted(jax, vi, card, args):
    """On the fitted problem: one objective evaluation split into
    prologue and LD matvec, for the production grid and for K=18."""
    import numpy as np
    from vilma_tpu.inference import engine
    from vilma_tpu.utils import synthetic

    data, st = vi.data, vi.state
    with vi._mesh_ctx():
        _objective_split(jax, engine, data, st, 'production grid', card)
        # K=18: the same panel and sumstats, an 18-component grid
        covs = [np.eye(2) * sc for sc in np.geomspace(1e-6, 1e-2, 9)]
        covs += [np.array([[sc, 0.8 * sc], [0.8 * sc, sc]])
                 for sc in np.geomspace(1e-6, 1e-2, 9)]
        d18 = _rebuild(engine, data, covs)
        st18 = synthetic.synthetic_state(d18, compact=True)
        _objective_split(jax, engine, d18, st18, 'K=18', card)
    return 0


def _rebuild(engine, data, covs):
    """ModelData of the fitted problem (same layout, LD on the device)
    with another mixture grid and no error-scaling."""
    import numpy as np
    ld = [data.ld[i] for i in data.ld_index]
    ids = np.asarray(data.annotations)
    one_hot = (ids[:, None] == np.arange(data.num_annotations)[None, :])
    return engine.build_model_data(
        np.asarray(data.marginal_effects), np.asarray(data.std_errs), ld,
        one_hot.astype(np.float64), covs, scaled=False, scale_se=False,
        gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
        dtype=np.float32)


def _objective_split(jax, engine, data, st, label, card):
    if st.nat_hist is not None:
        def obj(d, s):
            return engine._objective_epoch(d, s, s.nat_mu, s.nat_hist_c,
                                           s.hyper_delta)
    else:
        def obj(d, s):
            return engine._objective_compact(d, s, s.nat_mu, s.hyper_delta)
    full = jax.jit(lambda d, s: obj(d, s)[0])
    # post means alone: XLA drops the LD matvec and the likelihood
    prologue = jax.jit(lambda d, s: obj(d, s)[1])
    pm = prologue(data, st)
    matvec = jax.jit(lambda d, p: engine._ld_scaled_dot(d, p)[1])
    t_full = _timeit(full, data, st, reps=3)
    t_pro = _timeit(prologue, data, st, reps=3)
    t_mv = _timeit(matvec, data, pm, reps=3)
    K = data.mixture_prec.shape[0]
    say(f'  one objective evaluation, {label} (K={K}): total '
        f'{t_full * 1e3:.3f} ms, prologue {t_pro * 1e3:.3f} ms, '
        f'LD matvec {t_mv * 1e3:.3f} ms (block_until_ready) [{card}]')


def phase_parity(args):
    """f64 and f32 CLI fits of the 100K inputs, each in its own child;
    the comparisons run here, in numpy."""
    root = os.path.join(args.work, 'in')
    legs = [('f64', ['--precision', 'f64'], {})] + [
        (name, ['--precision', 'f32'], env) for name, env in PARITY_F32]
    res = {}
    for name, opts, env in legs:
        out = os.path.join(args.work, 'parity_' + name.replace(' ', '_'))
        log = out + '.log'
        argv = fit_argv(root, out, PARITY_ITS, opts)
        t = time.perf_counter()
        rc = _run_child([sys.executable, os.path.abspath(__file__),
                         '--phase', 'logged-fit', '--log', log,
                         '--argv', json.dumps(argv)], env=env)
        say(f'  fit {name} {" ".join(opts)} {env or ""}: rc {rc}, '
            f'{time.perf_counter() - t:.1f} s')
        if rc:
            return rc
        res[name] = _read_logged_fit(out, log)
    ok = True
    for i, (name, _) in enumerate(PARITY_F32):
        good = _parity_bounds(name, res[name], res['f64'])
        if i == 0:
            ok &= good
        else:
            say(f'  ({name} is a reading: it does not decide the phase)')
    return 0 if ok else 1


def _read_logged_fit(out, log):
    """Estimates, ELBO trace and iteration count of a logged fit; prints
    its precision line and where its seconds went."""
    with open(log) as fh:
        records = [line.rstrip('\n').split(' ', 1) for line in fh]
    text = '\n'.join(m for _, m in records)

    def first(pattern):
        return next(float(t) for t, m in records if re.search(pattern, m))

    its = [float(t) for t, m in records if m.startswith('Completed iter')]
    compile_s = sum(float(x) for x in re.findall(
        r'Finished XLA compilation of .* in (\S+) sec', text))
    say(f'    {re.search(r"Precision .*", text).group(0)}; before the '
        f'first iteration {its[0] - first(r"^Fitting"):.1f} s (XLA '
        f'compilation {compile_s:.1f} s in all), mean iteration '
        f'{(its[-1] - its[0]) / max(len(its) - 1, 1):.4f} s')
    elbo = [float(x) for x in re.findall(r'ELBO = (\S+),', text)]
    n_its = int(re.search(r'Optimization ran for (\d+)', text).group(1))
    return read_estimates(out + '.estimates.tsv'), elbo, n_its


def _parity_bounds(name, fit32, fit64):
    """The drift bounds of tests/test_f32_genome_scale.py, f32 against
    f64 CLI fits."""
    import numpy as np
    (e32, elbo32, its32), (e64, elbo64, its64) = fit32, fit64
    ok = True
    for p in ('pop1', 'pop2'):
        post64 = np.asarray(e64['posterior_' + p], np.float64)
        post32 = np.asarray(e32['posterior_' + p], np.float64)
        sd = np.sqrt(np.maximum(e64['posterior_variance_' + p], 0))
        rel = np.abs(post32 - post64) / np.maximum(sd, 1e-12)
        q999 = float(np.quantile(rel, 0.999))
        beyond3 = float(np.mean(rel > 3.0))
        med = float(np.median(np.abs(post32 - post64))
                    / np.abs(post64).max())
        good = q999 <= 2.0 and beyond3 <= 2e-3 and med <= 1e-3
        ok &= good
        say(f'  {name} {p}: 99.9% quantile of |f32-f64|/sd {q999:.3e} '
            f'(<= 2), share beyond 3 sd {beyond3:.2e} (<= 2e-3), median '
            f'|f32-f64| / max|f64| {med:.2e} (<= 1e-3) '
            f'{"ok" if good else "FAIL"}')
    rel_elbo = abs(elbo32[-1] - elbo64[-1]) / abs(elbo64[-1])
    good = rel_elbo <= 5e-3 and np.all(np.isfinite(elbo32 + elbo64))
    ok &= good
    say(f'  {name} final ELBO {elbo32[-1]!r}, f64 {elbo64[-1]!r}: relative '
        f'difference {rel_elbo:.2e} (<= 5e-3) {"ok" if good else "FAIL"}')
    good = abs(its32 - its64) <= 2
    ok &= good
    say(f'  {name} iterations run {its32}, f64 {its64} (within 2) '
        f'{"ok" if good else "FAIL"}')
    return ok


def phase_logged_fit(args):
    """`vilma-tpu <argv>` with its log lines (INFO, and JAX's compile
    seconds) saved to --log."""
    _jax()
    from vilma_tpu import frontend
    clock = _LogClock()
    frontend.main(json.loads(args.argv))
    with open(args.log, 'w') as fh:
        fh.write(''.join(f'{t:.3f} {m}\n' for t, m in clock.records))
    return 0


def phase_gpu_tests(args):
    env = dict(os.environ, JAX_PLATFORMS='cuda,cpu')
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '-m', 'gpu', '-q', '-rs',
         '-p', 'no:cacheprovider', os.path.join(HERE, 'tests')],
        cwd=HERE, env=env, capture_output=True, text=True)
    tail = proc.stdout.strip().splitlines()[-15:]
    say('\n'.join('  ' + line for line in tail))
    if proc.returncode:
        say(proc.stderr[-3000:])
        return proc.returncode
    if 'skipped' in tail[-1] or 'passed' not in tail[-1]:
        say('FAIL: gpu tests skipped or did not run')
        return 1
    return 0


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

# the sharded comparison keeps f32 LD: with bf16 LD the matvec re-rounds
# t = s * (U^T x) to bf16, which turns the last-bit differences of
# reassociated f32 sums into bf16 ulps
SHARDED_FIT = ['--precision', 'f32', '--ld-precision', 'f32',
               '--no-save-vi-sigma']


def phase_four(args):
    res = compare_sharded(args.work, os.path.join(args.work, 'in'), FIT_ITS)
    return 0 if res['ok'] else 1


def distributed_launches(root, out, its, port, env=None):
    """(command, environment) of each of the four `fit --distributed
    --mesh snp=4` processes. Process i sees only GPU i: a JAX process
    reserves most of the memory of every GPU it sees."""
    launches = []
    for pid in range(4):
        argv = fit_argv(root, out, its,
                        SHARDED_FIT + ['--mesh', 'snp=4', '--distributed',
                                       '--coordinator', f'localhost:{port}',
                                       '--num-processes', '4',
                                       '--process-id', str(pid)])
        launches.append(([sys.executable, '-m', 'vilma_tpu.frontend'] + argv,
                         _child_env(dict(env or {},
                                         CUDA_VISIBLE_DEVICES=str(pid)))))
    return launches


def compare_sharded(work, root, its, env=None, mesh_env=None):
    """Fit the inputs under `root` on one device and with --mesh snp=4
    (one after the other in one process), then with --distributed --mesh
    snp=4 as four processes; print each sharded fit's posterior means
    against the 1-device fit as soon as it ends, and the collectives of
    the sharded outer step. `env` is added to every child's environment,
    `mesh_env` to the one-process child's. Returns {'ok', 'mesh', 'dist',
    'collectives'}."""
    res = {'ok': False}
    t = time.perf_counter()
    inv_path = os.path.join(work, 'collectives.json')
    argvs = [fit_argv(root, os.path.join(work, 'one'), its, SHARDED_FIT),
             fit_argv(root, os.path.join(work, 'mesh'), its,
                      SHARDED_FIT + ['--mesh', 'snp=4'])]
    rc = _run_child([sys.executable, os.path.abspath(__file__),
                     '--phase', 'sharded-fits', '--log', inv_path,
                     '--argv', json.dumps(argvs)],
                    env=dict(env or {}, **(mesh_env or {})))
    say(f'  1-device and --mesh snp=4 fits (1 process): rc {rc}, '
        f'{time.perf_counter() - t:.1f} s')
    if rc:
        return res
    with open(inv_path) as fh:
        res['collectives'] = {k: tuple(v) for k, v in json.load(fh).items()}
    good = set(res['collectives']) <= {'all-reduce'}
    ok = good
    say(f'  collectives in the compiled outer step on 4 devices '
        f'{{op: (count, bytes)}}: {res["collectives"]} (all-reduce only) '
        f'{"ok" if good else "FAIL"}')
    ok &= _against_one(work, 'mesh', its, res)
    with socket.socket() as sk:
        sk.bind(('localhost', 0))
        port = sk.getsockname()[1]
    t = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=HERE, env=e) for cmd, e in
             distributed_launches(root, os.path.join(work, 'dist'), its,
                                  port, env)]
    rcs = [p.wait() for p in procs]
    say(f'  --distributed --mesh snp=4 fit (4 processes): rcs {rcs}, '
        f'{time.perf_counter() - t:.1f} s')
    if any(rcs):
        return res
    ok &= _against_one(work, 'dist', its, res)
    res['ok'] = ok
    return res


def _against_one(work, name, its, res):
    """Print and record the largest difference of fit `name`'s posterior
    means from the 1-device fit's, relative to their largest value."""
    import numpy as np
    one = read_estimates(os.path.join(work, 'one.estimates.tsv'))
    other = read_estimates(os.path.join(work, f'{name}.estimates.tsv'))
    worst = 0.0
    for p in ('pop1', 'pop2'):
        a = np.asarray(one['posterior_' + p], np.float64)
        b = np.asarray(other['posterior_' + p], np.float64)
        worst = max(worst, float(np.max(np.abs(a - b)) / np.max(np.abs(a))))
    res[name] = worst
    good = worst <= SHARDED_TOL
    say(f'  {name} vs 1 device: max |difference| / max |posterior| '
        f'{worst:.3e} (tol {SHARDED_TOL:.0e}: f32 sums reassociated across '
        f'shards, {its} iterations) {"ok" if good else "FAIL"}')
    return good


def phase_sharded_fits(args):
    """The fits of --argv (a list of argument lists), one after the other;
    then the collectives of the last one's compiled outer step, saved as
    JSON to --log."""
    jax = _jax()
    from vilma_tpu import frontend
    from vilma_tpu.inference import engine
    from analyze_collectives import collective_inventory
    fits = _capture_fits()
    for argv in json.loads(args.argv):
        t = time.perf_counter()
        frontend.main(argv)
        say(f'    fit {argv[argv.index("--output") + 1]}: '
            f'{time.perf_counter() - t:.1f} s')
    vi = fits[-1]
    with vi._mesh_ctx():
        hlo = engine.outer_step_donated.lower(
            vi.data, vi.state, line_search_rate=2.0).compile().as_text()
    with open(args.log, 'w') as fh:
        json.dump(collective_inventory(hlo), fh)
    return 0


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

def _child_env(extra=None):
    env = dict(os.environ)
    env['PYTHONPATH'] = HERE + os.pathsep + env.get('PYTHONPATH', '')
    env.update(extra or {})
    return env


def _run_child(cmd, env=None):
    return subprocess.run(cmd, cwd=HERE, env=_child_env(env)).returncode


PHASES = {'device': phase_device, 'gen': phase_gen, 'fit': phase_fit,
          'parity': phase_parity, 'gpu-tests': phase_gpu_tests,
          'four': phase_four, 'sharded-fits': phase_sharded_fits,
          'logged-fit': phase_logged_fit}
# phases that import JAX run in a child of their own; the others
# orchestrate children or use numpy only
_IN_CHILD = {'device', 'fit'}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--parity', action='store_true',
                      help='run only the f32-vs-f64 fits at 100K SNPs')
    mode.add_argument('--four-cards', action='store_true',
                      help='run only the 4-GPU sharded comparison')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--phase', help=argparse.SUPPRESS)
    ap.add_argument('--work', default=WORK, help=argparse.SUPPRESS)
    ap.add_argument('--argv', help=argparse.SUPPRESS)
    ap.add_argument('--log', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, 'vilma_tpu')):
        print('chip_smoke.py must run from a vilma-tpu checkout',
              file=sys.stderr)
        return 2
    if args.phase:
        return PHASES[args.phase](args)

    if args.four_cards:
        order = ['device', 'gen', 'four']
    elif args.parity:
        order = ['device', 'gen', 'parity']
    else:
        order = ['device', 'gen', 'fit', 'gpu-tests']
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    t_all = time.perf_counter()
    try:
        for name in order:
            say(f'== phase {name}')
            t = time.perf_counter()
            if name in _IN_CHILD:
                rc = _run_child([sys.executable, os.path.abspath(__file__),
                                 '--phase', name, '--work', args.work,
                                 '--seed', str(args.seed)])
            else:
                rc = PHASES[name](args)
            say(f'== phase {name}: rc {rc}, '
                f'{time.perf_counter() - t:.1f} s')
            if rc:
                return rc
        with open(os.path.join(args.work, 'device.json')) as fh:
            device = json.load(fh)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    say(f'total {time.perf_counter() - t_all:.1f} s')
    say(f'card: {smi()}')
    print(json.dumps({'ok': True, 'device': device}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
