"""Inventory the cross-device collectives in one sharded outer_step.

Compiles the full VI iteration over an 8-way simulated `snp` mesh and
counts every collective op (all-reduce / all-gather / reduce-scatter /
collective-permute / all-to-all) in the optimized HLO, with payload
bytes. This is the communication side of the multi-host scaling model:
per-iteration cross-device traffic is O(I) bytes (the genome<->block
permutation's gather/scatter crossing shard boundaries) plus scalar
ELBO/convergence reductions — per mesh axis, independent of K and of
the LD payload, which never moves after setup. See BASELINE.md
("Scaling model") for the recorded numbers.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python analyze_collectives.py [NUM_LOCI]

Multi-process mode (`--distributed N [NUM_LOCI]`): launches an N-process
jax.distributed CPU cluster (8 global devices), loads a synthetic schema
through the shard-local multi-process loader
(parallel.distributed.plan_sharded_load + load_ld_sharded), and prints
rank 0's collective inventory of the compiled outer step — the program a
real pod runs under `fit --distributed`.
"""
import os
import re
import sys

import numpy as np

_DTYPE_BYTES = {'f64': 8, 'f32': 4, 'bf16': 2, 'f16': 2,
                's64': 8, 's32': 4, 'u64': 8, 'u32': 4,
                's8': 1, 'u8': 1, 'pred': 1}

_SHAPE_RE = re.compile(r'(f64|f32|bf16|f16|s64|s32|u64|u32|s8|u8|pred)'
                       r'\[([0-9,]*)\]')
# a GPU module splits each collective into an async -start/-done pair:
# the -start op is counted
_OP_RE = re.compile(r'= (\(?[^=]*?\)?) (all-reduce|all-gather|'
                    r'reduce-scatter|collective-permute|all-to-all)'
                    r'(?:-start)?\(')


def _shape_bytes(shape_text):
    """Total payload bytes of a (possibly tuple) HLO shape string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_text):
        n = 1
        for d in dims.split(','):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_inventory(hlo_text):
    """{op_kind: (count, total_bytes)} over an optimized HLO module."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shape_text, op = m.groups()
        cnt, byt = out.get(op, (0, 0))
        out[op] = (cnt + 1, byt + _shape_bytes(shape_text))
    return out


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from vilma_tpu.inference import engine
    from vilma_tpu.parallel import mesh as mesh_mod
    from vilma_tpu.utils import synthetic

    num_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    n_snp = 8
    if len(jax.devices()) < n_snp:
        raise SystemExit('need XLA_FLAGS=--xla_force_host_platform_'
                         f'device_count={n_snp}')
    mesh = mesh_mod.make_mesh(n_snp=n_snp)

    def report(tag, hlo):
        inv = collective_inventory(hlo)
        print(f'collectives in one sharded outer_step — {tag} '
              f'({n_snp}-way snp mesh, I={num_loci}, P=2, f64):')
        total = 0
        for op, (cnt, byt) in sorted(inv.items()):
            print(f'  {op:20s} count={cnt:3d}  bytes={byt:>12,}')
            total += byt
        print(f'  {"TOTAL":20s} {"":10s}  bytes={total:>12,}'
              f'  ({total / max(num_loci, 1):.1f} B/SNP)')
        return inv

    # -- legacy layout: genome-order gather/scatter under SPMD ------------
    data = synthetic.synthetic_problem(num_loci=num_loci, num_pops=2,
                                       num_components=4, block_size=64,
                                       num_annotations=2,
                                       dtype=np.float64)
    state = synthetic.synthetic_state(data)
    sdata = mesh_mod.shard_data(data, mesh)
    sstate = mesh_mod.shard_state(state, mesh)
    with jax.set_mesh(mesh):
        hlo = jax.jit(
            lambda d, s: engine.outer_step_impl(d, s, 2.0),
        ).lower(sdata, sstate).compile().as_text()
    report('global-gather layout', hlo)

    # -- shard-local layout: collective-free matvec (the production
    #    `fit --mesh` path since round 3) ---------------------------------
    from vilma_tpu.parallel import alignment
    from vilma_tpu.ops import blocks as blocks_mod
    ld = data.ld[0]
    lmap, L, ok = alignment.compute_layout([ld], num_loci,
                                           n_shards=n_snp)
    assert ok
    lds = alignment.relayout_ld(ld, lmap, L, n_shards=n_snp)
    rng = np.random.default_rng(0)
    betas = alignment.relayout_rows(
        np.asarray(data.marginal_effects), lmap, L, fill=0.0)
    ses = alignment.relayout_rows(np.asarray(data.std_errs), lmap, L,
                                  fill=1.0)
    annot = np.zeros((L, 2))
    annot[lmap, rng.integers(0, 2, num_loci)] = 1
    covs = np.linalg.inv(np.asarray(data.mixture_prec))
    with jax.set_mesh(mesh):
        data2 = engine.build_model_data(
            betas, ses, [lds, lds], annot, covs, scaled=False,
            scale_se=False, gwas_N=np.full(2, 1e5),
            init_hg=np.full(2, 0.3), dtype=np.float64)
        state2 = synthetic.synthetic_state(data2)
        sdata2 = mesh_mod.shard_data(data2, mesh)
        sstate2 = mesh_mod.shard_state(state2, mesh)
        hlo2 = jax.jit(
            lambda d, s: engine.outer_step_impl(d, s, 2.0),
        ).lower(sdata2, sstate2).compile().as_text()
    return report('shard-local layout', hlo2)


def _build_synth_schema(root, num_loci, block):
    """Synthetic AR(1) dense-block schema + extract file on disk."""
    rng = np.random.default_rng(0)
    rows, ids = [], []
    start = 0
    b = 0
    while start < num_loci:
        size = min(block, num_loci - start)
        idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        np.save(f'{root}_{b}.npy', rng.uniform(0.3, 0.9) ** idx)
        with open(f'{root}_{b}.var', 'w') as fh:
            for i in range(size):
                name = f'snp{b}_{i}'
                ids.append(name)
                fh.write(f'{name}\t1\t{start + i + 1}\t0\tA\tT\n')
        rows.append(f'{root}_{b}.var\t{root}_{b}.npy')
        start += size
        b += 1
    with open(root + '.schema', 'w') as fh:
        fh.write('\n'.join(rows) + '\n')
    with open(root + '.schema.extract', 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.write(''.join(f'{name}\tA\tT\n' for name in ids))
    return root + '.schema'


def _worker_distributed():
    """Child body for --distributed mode (driven by AC_* env vars)."""
    pid = int(os.environ['AC_PID'])
    nproc = int(os.environ['AC_NPROC'])
    ndev = int(os.environ['AC_NDEV'])
    num_loci = int(os.environ['AC_LOCI'])
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['XLA_FLAGS'] = (
        os.environ.get('XLA_FLAGS', '')
        + f' --xla_force_host_platform_device_count={ndev}')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{os.environ['AC_PORT']}",
        num_processes=nproc, process_id=pid)
    import pandas as pd
    from jax.sharding import Mesh
    from vilma_tpu.parallel import alignment, distributed
    from vilma_tpu.inference import MultiPopVI, engine
    from vilma_tpu.parallel import mesh as mesh_mod

    schema = os.environ['AC_SCHEMA']
    variants = pd.read_csv(schema + '.extract', sep='\t')
    devices = distributed.process_contiguous_devices()
    mesh = Mesh(np.asarray(devices).reshape(1, len(devices)),
                axis_names=('comp', 'snp'))
    plan = distributed.plan_sharded_load([(schema, [])], variants,
                                         len(devices))
    assert plan is not None
    ld, _ = distributed.load_ld_sharded(schema, variants, denylist=[],
                                        ldthresh=1.0, mesh=mesh,
                                        plan=plan)
    n = variants.shape[0]
    rng = np.random.default_rng(1)
    ses = rng.uniform(0.01, 0.05, (2, n))
    betas = rng.standard_normal((2, n)) * ses * 2
    betas = alignment.relayout_rows(betas, plan.layout_map, plan.L, 0.0)
    ses = alignment.relayout_rows(ses, plan.layout_map, plan.L, 1.0)
    annot = alignment.relayout_annotations(np.ones((n, 1)),
                                           plan.layout_map, plan.L)
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    np.random.seed(0)
    vi = MultiPopVI(marginal_effects=betas, std_errs=ses,
                    ld_mats=[ld, ld], annotations=annot,
                    mixture_covs=covs, checkpoint=False,
                    gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
                    num_its=2, mesh=mesh, out_index=plan.layout_map)
    st = vi._initialize()
    st = mesh_mod.shard_state(st, mesh)
    with jax.set_mesh(mesh):
        hlo = jax.jit(
            lambda d, s: engine.outer_step_impl(d, s, 2.0),
        ).lower(vi.data, st).compile().as_text()
    if pid == 0:
        inv = collective_inventory(hlo)
        print(f'collectives in one outer_step — {nproc}-process '
              f'shard-local cluster ({len(devices)}-way snp mesh, '
              f'I={num_loci}, P=2, f64):')
        total = 0
        for op, (cnt, byt) in sorted(inv.items()):
            print(f'  {op:20s} count={cnt:3d}  bytes={byt:>12,}')
            total += byt
        print(f'  {"TOTAL":20s} {"":10s}  bytes={total:>12,}'
              f'  ({total / max(num_loci, 1):.3f} B/SNP)')


def main_distributed(nproc, num_loci):
    """Parent for --distributed: build the schema, fork the cluster."""
    import socket
    import subprocess
    import tempfile
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix='ac_dist_')
    schema = _build_synth_schema(os.path.join(tmp, 'synth'), num_loci,
                                 block=512)
    ndev = 8 // nproc
    procs = []
    for pid in range(nproc):
        env = dict(os.environ,
                   AC_PID=str(pid), AC_NPROC=str(nproc),
                   AC_PORT=str(port), AC_NDEV=str(ndev),
                   AC_LOCI=str(num_loci), AC_SCHEMA=schema,
                   AC_CHILD='1')
        env.pop('XLA_FLAGS', None)
        procs.append(subprocess.Popen([sys.executable,
                                       os.path.abspath(__file__)],
                                      env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f'cluster worker failed: {rcs}')


if __name__ == '__main__':
    if os.environ.get('AC_CHILD'):
        _worker_distributed()
    elif len(sys.argv) > 1 and sys.argv[1] == '--distributed':
        main_distributed(int(sys.argv[2]),
                         int(sys.argv[3]) if len(sys.argv) > 3 else 8192)
    else:
        main()
