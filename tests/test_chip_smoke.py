"""chip_smoke.py off the chip: its inputs, its parity bounds, its refusal
to run without a GPU, and the four-GPU comparison at a small size on the
CPU (4 simulated devices for --mesh snp=4, 4 CPU processes for
--distributed), through the code `chip_smoke.py --four-cards` runs."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_block_sizes_cover_the_genome():
    sizes = chip_smoke.block_sizes(100_000, seed=0)
    assert sum(sizes) == 100_000
    assert min(sizes[:-1]) >= 256 and max(sizes) <= 1536
    assert 500 <= np.mean(sizes) <= 750


def test_distributed_launches_bind_one_gpu_each(tmp_path):
    launches = chip_smoke.distributed_launches(
        str(tmp_path), str(tmp_path / 'dist'), 3, 1234)
    assert [env['CUDA_VISIBLE_DEVICES'] for _, env in launches] == [
        '0', '1', '2', '3']
    for pid, (cmd, env) in enumerate(launches):
        assert cmd[cmd.index('--process-id') + 1] == str(pid)
        assert cmd[cmd.index('--mesh') + 1] == 'snp=4'
        assert cmd[cmd.index('--coordinator') + 1] == 'localhost:1234'
        assert ROOT in env['PYTHONPATH'].split(os.pathsep)


def _fit(post, var, elbo, its):
    est = {'posterior_pop1': post[0], 'posterior_pop2': post[1],
           'posterior_variance_pop1': var, 'posterior_variance_pop2': var,
           'n': post.shape[1]}
    return est, elbo, its


def test_parity_bounds():
    rng = np.random.default_rng(0)
    post = rng.standard_normal((2, 1000)) * 1e-3
    var = np.full(1000, 1e-6)
    ref = _fit(post, var, [-2.0, -1.0], 10)
    assert chip_smoke._parity_bounds('f32', _fit(post + 1e-7, var,
                                                 [-2.0, -1.0001], 11), ref)
    # every mean 5 sd away
    assert not chip_smoke._parity_bounds('f32', _fit(post + 5e-3, var,
                                                     [-2.0, -1.0], 10), ref)
    assert not chip_smoke._parity_bounds('f32', _fit(post, var,
                                                     [-2.0, -1.1], 10), ref)
    assert not chip_smoke._parity_bounds('f32', _fit(post, var,
                                                     [-2.0, -1.0], 13), ref)


def test_refuses_to_run_without_a_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
         '--work', str(tmp_path / 'work')],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert 'FAIL: JAX found no GPU' in proc.stdout
    assert '"ok"' not in proc.stdout


def test_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_sharded_fits_match_one_device_on_cpu(tmp_path):
    root = str(tmp_path / 'in')
    chip_smoke.write_inputs(root, 12_000, seed=0)
    # the epoch-history state and the K-chunked objective, as at 1M SNPs
    env = {'JAX_PLATFORMS': 'cpu', 'XLA_FLAGS': '',
           'VILMA_EPOCH_STATE_BYTES': '0',
           'VILMA_XLA_KI_CHUNK_BYTES': str(1 << 20)}
    res = chip_smoke.compare_sharded(
        str(tmp_path), root, 2, env=env,
        mesh_env={'XLA_FLAGS': '--xla_force_host_platform_device_count=4'})
    assert res['ok'], res
    assert res['mesh'] <= chip_smoke.SHARDED_TOL
    assert res['dist'] <= chip_smoke.SHARDED_TOL
    assert set(res['collectives']) == {'all-reduce'}
    with open(tmp_path / 'collectives.json') as fh:
        assert json.load(fh)['all-reduce'][0] >= 1
