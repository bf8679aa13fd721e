"""--mmap disk spill: correctness and the bounded-host-RAM guarantee.

The reference's --mmap exists so 60-70 GB whole-genome LD schemas load
without holding all factor payloads in RAM (reference
matrix_structures.py:120-135, README.md:417-424). Here we prove the
equivalent property of FactorSpill with a hard OS limit: a subprocess
with RLIMIT_DATA capped loads a synthetic schema whose factor payload
exceeds what the unspilled path would allocate (factors + packed bucket
tensors coexist at ~2x payload); the spilled path must succeed under the
cap, while the same cap kills the unspilled load.

RLIMIT_DATA covers brk + anonymous mmaps (Linux >= 4.7) but NOT
file-backed maps, which is exactly the distinction the spill is designed
around.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from vilma_tpu.io import load
from vilma_tpu.ops import blocks

_WORKER = r'''
import resource, sys
import numpy as np

headroom_mb = int(sys.argv[1])
schema = sys.argv[2]
use_mmap = sys.argv[3] == "mmap"

import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
# pin the CPU in config too, before any backend use
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from vilma_tpu.io import load
from vilma_tpu.ops import blocks
import pandas as pd
import jax.numpy as jnp

variants = pd.read_csv(schema + ".extract", sep="\t")
jnp.asarray(np.zeros(8)).block_until_ready()   # init the CPU backend

# RLIMIT_DATA constrains VmData (brk + anonymous mmaps, Linux >= 4.7) but
# NOT file-backed maps; self-calibrate against the interpreter+jax
# baseline so only the load's own anonymous allocations count.
def vmdata_kb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmData"):
                return int(line.split()[1])
soft = (vmdata_kb() + headroom_mb * 1024) * 1024
resource.setrlimit(resource.RLIMIT_DATA, (soft, soft))
try:
    packed, missing = load.load_ld_from_schema(
        schema, variants, denylist=[], ldthresh=1.0, mmap=use_mmap)
except MemoryError:
    print("OOM")
    sys.exit(0)
print("OK", packed.n, int(packed.rank), len(packed.buckets))
'''


def _build_schema(tmp_path, num_blocks=24, block=512):
    """A synthetic schema with ~`num_blocks * block^2 * 8` bytes of dense
    payload (24 x 512 x 512 x 8 = 48 MiB of factors after full-rank
    eigendecomposition)."""
    rng = np.random.default_rng(0)
    root = str(tmp_path / 'spill_schema')
    rows = []
    ids = []
    for b in range(num_blocks):
        idx = np.abs(np.subtract.outer(np.arange(block), np.arange(block)))
        mat = 0.9 ** idx
        np.save(f'{root}_{b}.npy', mat)
        with open(f'{root}_{b}.var', 'w') as fh:
            for i in range(block):
                name = f'snp{b}_{i}'
                ids.append(name)
                fh.write(f'{name}\t1\t{b * block + i + 1}\t0\tA\tT\n')
        rows.append(f'{root}_{b}.var\t{root}_{b}.npy')
    with open(root + '.schema', 'w') as fh:
        fh.write('\n'.join(rows) + '\n')
    with open(root + '.schema.extract', 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.write(''.join(f'{name}\tA\tT\n' for name in ids))
    del rng
    return root + '.schema'


def _run_worker(schema, cap_mb, mode):
    env = dict(os.environ)
    env['PYTHONPATH'] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep
        + env.get('PYTHONPATH', ''))
    out = subprocess.run([sys.executable, '-c', _WORKER, str(cap_mb),
                          schema, mode],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    return out


@pytest.mark.slow
def test_spill_loads_under_ram_cap(tmp_path):
    schema = _build_schema(tmp_path)
    payload_mb = 24 * 512 * 512 * 8 // (1024 * 1024)        # 48 MiB
    # budget: the spilled path's anonymous high-water is one block's
    # transient factorization (a few MB); the unspilled path holds
    # factors + packed bucket tensors, >= 2x payload
    headroom_mb = payload_mb
    # spilled: must fit under the cap and produce a working PackedLD
    out = _run_worker(schema, headroom_mb, 'mmap')
    assert out.stdout.startswith('OK'), (out.stdout, out.stderr[-2000:])
    # unspilled: the same cap must actually bite; if this ever passes, the
    # cap is too loose for the positive assertion above to mean anything
    out2 = _run_worker(schema, headroom_mb, 'plain')
    assert not out2.stdout.startswith('OK'), (
        'RAM cap did not constrain the unspilled load; test is vacuous')


def test_spill_matches_unspilled(tmp_path):
    """Same PackedLD numerics with and without the spill."""
    schema = _build_schema(tmp_path, num_blocks=3, block=64)
    import pandas as pd
    variants = pd.read_csv(schema + '.extract', sep='\t')
    np.random.seed(0)
    plain, missing1 = load.load_ld_from_schema(schema, variants,
                                               denylist=[], ldthresh=1.0,
                                               mmap=False)
    np.random.seed(0)
    spilled, missing2 = load.load_ld_from_schema(schema, variants,
                                                 denylist=[], ldthresh=1.0,
                                                 mmap=True)
    assert missing1 == missing2
    x = np.random.default_rng(1).standard_normal(plain.n)
    assert np.allclose(np.asarray(blocks.dot(plain, x)),
                       np.asarray(blocks.dot(spilled, x)),
                       rtol=1e-12, atol=1e-12)
    assert plain.rank == spilled.rank
