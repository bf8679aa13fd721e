"""Validation modes: gradient-ascent ELBO and NUTS/SMC posterior checks.

Gradient-based ELBO optimization plus NUTS/SMC
posterior checks on small blocks validate the coordinate-ascent VI
engine's answers against independent inference procedures.
"""
import numpy as np
import jax.numpy as jnp

from vilma_tpu.ops import blocks
from vilma_tpu.inference import engine, gradient, mcmc


def small_problem(seed=0, n=16, rho=0.4):
    rng = np.random.default_rng(seed)
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    ld = rho ** idx
    packed = blocks.from_dense_blocks([ld], [np.arange(n)], n)
    se = np.full((1, n), 0.05)
    true_beta = np.where(rng.random(n) < 0.3,
                         rng.standard_normal(n) * 0.1, 0.0)
    betas = (ld @ true_beta + rng.standard_normal(n) * 0.05)[None]
    covs = [np.eye(1) * 1e-6, np.eye(1) * 0.01, np.eye(1) * 0.05]
    annotations = np.ones((n, 1))
    scheme = engine.MultiPopVI(
        marginal_effects=betas, std_errs=se, ld_mats=[packed],
        mixture_covs=covs, annotations=annotations, checkpoint=False,
        checkpoint_freq=-1, output='/tmp/vilma_tpu_val', scaled=False,
        scale_se=False, gwas_N=np.array([1e4]), init_hg=np.array([0.3]),
        num_its=60)
    return scheme, ld, betas, se, np.asarray(covs)


def test_gradient_mode_matches_coordinate_ascent():
    np.random.seed(0)
    scheme, *_ = small_problem()
    st = scheme.optimize()
    ca_elbo = scheme.elbo_value(st)
    st0 = scheme._initialize()
    (vi_mu, vi_delta, hyper), trace = gradient.fit_elbo_gradient(
        scheme.data, st0, num_steps=800, learning_rate=5e-2)
    grad_elbo = trace[-1]
    # gradient ascent should improve monotonically-ish and land near the
    # coordinate-ascent optimum
    assert trace[-1] > trace[0]
    assert grad_elbo > ca_elbo - 0.05 * abs(ca_elbo) - 5.0


def test_smc_agrees_with_vi():
    """Annealed SMC handles the spike-and-slab multimodality; its
    posterior means validate the VI answer on the full mixture prior."""
    np.random.seed(0)
    scheme, ld, betas, se, covs = small_problem(n=8)
    st = scheme.optimize()
    vi_mean = scheme.real_posterior_mean(st)          # [1, n]
    weights = np.asarray(st.hyper_delta)              # [1, K]

    log_post = mcmc.make_block_log_posterior(
        ld, betas, se, covs, weights, np.zeros(8, dtype=int))
    sampler = mcmc.mixture_prior_sampler(covs, weights,
                                         np.zeros(8, dtype=int), 1)
    smc = mcmc.smc_sample(log_post, sampler, num_particles=1500,
                          num_steps=25, num_mcmc=5, seed=2)
    smc_mean = smc.mean(axis=0)

    scale = np.abs(betas).max()
    assert np.allclose(vi_mean, smc_mean, atol=0.1 * scale)


def test_nuts_agrees_with_vi_unimodal():
    """NUTS requires a unimodal-ish target (single step size cannot hop
    the near-zero spike), so validate on a spike-free mixture."""
    rng = np.random.default_rng(3)
    n = 8
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    ld = 0.4 ** idx
    packed = blocks.from_dense_blocks([ld], [np.arange(n)], n)
    se = np.full((1, n), 0.05)
    true_beta = rng.standard_normal(n) * 0.1
    betas = (ld @ true_beta + rng.standard_normal(n) * 0.05)[None]
    covs = [np.eye(1) * 0.01, np.eye(1) * 0.05]
    scheme = engine.MultiPopVI(
        marginal_effects=betas, std_errs=se, ld_mats=[packed],
        mixture_covs=covs, annotations=np.ones((n, 1)), checkpoint=False,
        checkpoint_freq=-1, output='/tmp/vilma_tpu_val2', scaled=False,
        scale_se=False, gwas_N=np.array([1e4]), init_hg=np.array([0.3]),
        num_its=60)
    np.random.seed(1)
    st = scheme.optimize()
    vi_mean = scheme.real_posterior_mean(st)
    weights = np.asarray(st.hyper_delta)

    log_post = mcmc.make_block_log_posterior(
        ld, betas, se, np.asarray(covs), weights, np.zeros(n, dtype=int))
    nuts = mcmc.nuts_sample(log_post, np.zeros((1, n)), num_samples=1500,
                            num_warmup=500, seed=1)
    nuts_mean = nuts.mean(axis=0)
    scale = np.abs(betas).max()
    assert np.allclose(vi_mean, nuts_mean, atol=0.1 * scale)
