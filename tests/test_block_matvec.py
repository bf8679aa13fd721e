"""The LD block matvec on XLA's path (ops/blocks.py) against dense
float64 numpy: single and batched right-hand sides, bf16 eigenvectors,
both gather/scatter layouts, and a fit trajectory in f32."""
import numpy as np
import jax.numpy as jnp
import pytest

from vilma_tpu.ops import blocks, lowrank


def _bucket(B, P, R, u_dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, P, R)) / np.sqrt(P)
    return blocks.BlockBucket(
        u=jnp.asarray(u, dtype=u_dtype),
        s=jnp.asarray(rng.uniform(0.1, 2, (B, R))), inv_s=None,
        d=jnp.asarray(rng.uniform(0, 1, (B, P))), perm=None, grows=None,
        srows=None, seq=None)


def _f64_product(bk, x):
    u = bk.u.astype(jnp.float32) if bk.u.dtype == jnp.bfloat16 else bk.u
    u = np.asarray(u, np.float64)
    x = np.asarray(x, np.float64)
    t = np.einsum('bpr,bcp->bcr', u, x) * np.asarray(bk.s)[:, None]
    return np.einsum('bpr,bcr->bcp', u, t) + np.asarray(bk.d)[:, None] * x


def test_bucket_matvec_matches_einsum():
    """Single right-hand side, P and R not powers of two."""
    bk = _bucket(3, 100, 40)
    x = np.random.default_rng(1).standard_normal((3, 100))
    got = np.asarray(blocks._bucket_dot(bk, jnp.asarray(x)))
    want = _f64_product(bk, x[:, None])[:, 0]
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('nrhs', [1, 2, 3])
def test_bucket_matvec_multi_matches_einsum(nrhs):
    """C right-hand sides share one pass of the batched products, and
    each equals the single-vector matvec."""
    bk = _bucket(2, 256, 200, seed=nrhs)
    x = np.random.default_rng(nrhs).standard_normal((2, nrhs, 256))
    got = np.asarray(blocks._bucket_dot_multi(bk, jnp.asarray(x)))
    assert np.allclose(got, _f64_product(bk, x), rtol=1e-12, atol=1e-12)
    for c in range(nrhs):
        one = np.asarray(blocks._bucket_dot(bk, jnp.asarray(x[:, c])))
        assert np.allclose(got[:, c], one, rtol=1e-13, atol=1e-13)


def test_bucket_matvec_bf16_matches_f64():
    """bf16 eigenvectors (fit --ld-precision bf16): f32 accumulation with
    x and t rounded to bf16 stays within bf16's ~0.4% of the float64
    product of the same (rounded) eigenvectors."""
    bk = _bucket(2, 200, 72, u_dtype=jnp.bfloat16, seed=2)
    bk = blocks.BlockBucket(u=bk.u, s=bk.s.astype(jnp.float32), inv_s=None,
                            d=bk.d.astype(jnp.float32), perm=None,
                            grows=None, srows=None, seq=None)
    x = np.random.default_rng(2).standard_normal((2, 2, 200))
    got = np.asarray(blocks._bucket_dot_multi(
        bk, jnp.asarray(x, dtype=jnp.float32)))
    assert got.dtype == np.float32
    want = _f64_product(bk, x)
    assert np.max(np.abs(got - want)) <= 1e-2 * np.abs(want).max()


def _make_packed(row_aligned, dtype=np.float64):
    rng = np.random.default_rng(7)
    factors, indices = [], []
    n = 512
    starts = [0, 128, 384] if row_aligned else [0, 130, 384]
    sizes = [128, 256, 128] if row_aligned else [130, 200, 128]
    for st, sz in zip(starts, sizes):
        a = rng.standard_normal((sz, sz))
        f = lowrank.factor_block(X=(a @ a.T) / sz + np.eye(sz), t=1.0,
                                 check_symmetric=False)
        factors.append(f)
        indices.append(np.arange(st, st + sz))
    return blocks.pack(factors, indices, n, dtype=dtype)


@pytest.mark.parametrize('aligned', [True, False])
def test_dot_matches_dense(aligned):
    """dot / dot_multi on the row-aligned and the permutation layouts
    equal the dense matrix product, missing indices included."""
    ld = _make_packed(aligned)
    assert ld.row_aligned == aligned
    dense = blocks.to_dense(ld)
    x = np.random.default_rng(8).standard_normal((4, ld.n))
    assert np.allclose(np.asarray(blocks.dot(ld, jnp.asarray(x[0]))),
                       dense @ x[0], rtol=1e-11, atol=1e-11)
    assert np.allclose(np.asarray(blocks.dot_multi(ld, jnp.asarray(x))),
                       x @ dense.T, rtol=1e-11, atol=1e-11)


def test_engine_fit_f32_tracks_f64():
    """Five f32 outer steps follow the f64 trajectory closely at this
    toy size (the LD matvec and every K-reduction run in f32)."""
    from vilma_tpu.inference import engine
    from vilma_tpu.utils import synthetic

    def run(dtype):
        data = synthetic.synthetic_problem(num_loci=256, num_pops=2,
                                           num_components=3,
                                           block_size=128,
                                           num_annotations=2, dtype=dtype)
        st = synthetic.synthetic_state(data)
        for _ in range(5):
            st, pm = engine.outer_step(data, st, line_search_rate=2.0)
        return np.asarray(pm, np.float64), float(st.elbo)

    pm32, elbo32 = run(np.float32)
    pm64, elbo64 = run(np.float64)
    assert np.allclose(pm32, pm64, atol=1e-4 * np.abs(pm64).max())
    assert abs(elbo32 - elbo64) <= 1e-5 * abs(elbo64)
