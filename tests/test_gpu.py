"""Tests that need an NVIDIA GPU: the LD block matvec at genome-scale
bucket shapes, the objective in float64 on the card, and in f32 against
it. They carry the `gpu` marker and skip elsewhere. The CPU backend is
listed too, for the float64 comparison with it:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vilma_tpu.ops import blocks

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize('u_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('nrhs', [1, 2, 3])
def test_block_matvec_on_gpu(gpu, u_dtype, nrhs):
    """The bucket matvec at the shapes of a 1M-SNP panel's widest
    buckets, compiled for the card with HIGHEST f32 products, against
    float64 numpy: 1e-5 for f32 eigenvectors, 1e-2 for bf16 (x and t
    are rounded to bf16)."""
    rng = np.random.default_rng(nrhs)
    for B, P, R in [(32, 1024, 512), (8, 2048, 768)]:
        u = rng.standard_normal((B, P, R)) / np.sqrt(P)
        bk = blocks.BlockBucket(
            u=jnp.asarray(u, dtype=u_dtype),
            s=jnp.asarray(rng.uniform(0.1, 6.0, (B, R)), jnp.float32),
            inv_s=None,
            d=jnp.asarray(rng.uniform(0.0, 0.1, (B, P)), jnp.float32),
            perm=None, grows=None, srows=None, seq=None)
        x = rng.standard_normal((B, nrhs, P)).astype(np.float32)
        with jax.default_matmul_precision('highest'):
            got = np.asarray(jax.jit(blocks._bucket_dot_multi)(
                bk, jnp.asarray(x)))
        u64 = np.asarray(bk.u.astype(jnp.float32), np.float64)
        t = np.einsum('bpr,bcp->bcr', u64, x) * np.asarray(bk.s)[:, None]
        want = (np.einsum('bpr,bcr->bcp', u64, t)
                + np.asarray(bk.d)[:, None] * x)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= (1e-5 if u_dtype == 'float32' else 1e-2)


def _objective(dtype, device):
    """(objective, posterior means) of one compact parameter point."""
    from vilma_tpu.inference import engine
    from vilma_tpu.utils import synthetic
    with jax.default_device(device):
        data = synthetic.synthetic_problem(num_loci=2048, num_pops=2,
                                           num_components=4,
                                           block_size=256,
                                           num_annotations=2, dtype=dtype)
        st = synthetic.synthetic_state(data, seed=1, compact=True)
        obj, pm, _ = jax.jit(engine._objective_compact)(
            data, st, st.nat_mu, st.hyper_delta)
    return float(obj), np.asarray(pm, np.float64)


def test_f64_on_gpu_matches_cpu(gpu):
    """--precision f64 runs on the card: the float64 objective and
    posterior means there equal the CPU's to float64 rounding (the two
    backends sum in different orders and use different exp/log)."""
    with jax.enable_x64(True):
        obj_g, pm_g = _objective(np.float64, jax.devices('gpu')[0])
        obj_c, pm_c = _objective(np.float64, jax.devices('cpu')[0])
    assert np.isclose(obj_g, obj_c, rtol=1e-10)
    assert np.allclose(pm_g, pm_c, rtol=1e-9,
                       atol=1e-12 * np.abs(pm_c).max())


def test_f32_on_gpu_tracks_f64(gpu):
    """The f32 objective on the card (HIGHEST products) matches the
    float64 one."""
    with jax.default_matmul_precision('highest'):
        obj32, pm32 = _objective(np.float32, jax.devices('gpu')[0])
    with jax.enable_x64(True):
        obj64, pm64 = _objective(np.float64, jax.devices('gpu')[0])
    assert np.isclose(obj32, obj64, rtol=1e-5)
    assert np.allclose(pm32, pm64, atol=1e-5 * np.abs(pm64).max())
