"""Core numerical kernels for the VI engine, as fused XLA ops.

JAX equivalents of the reference's numba kernels
(reference numerics.py:11-290). Shapes follow the reference convention:
K = mixture components, P = populations, I = SNPs, A = annotations.

Design notes (SURVEY.md section 2.2):
  * every kernel is a pure jnp function safe under jit/vmap/sharding —
    elementwise chains fuse into neighbouring einsums, reductions lower to
    psums when the I axis is sharded over a mesh;
  * the [K,P,P,I] variational covariance `vi_sigma` of the reference is
    never materialized: all contractions against it are expressed through
    closed-form PxP solves (see vilma_tpu.models.sigma), and the kernels
    here take only [K,*,I] summaries;
  * the categorical clamp EPSILON is dtype-dependent (1e-100 in f64 per
    reference numerics.py:8, 1e-30 in f32 where 1e-100 underflows).
"""
import jax.numpy as jnp

from vilma_tpu.utils.config import epsilon


def sum_betas(old_beta, new_beta, step_size):
    """step*new + (1-step)*old (reference numerics.py:11-15)."""
    return step_size * new_beta + (1. - step_size) * old_beta


def fast_divide(x, y):
    """Elementwise x / y (reference numerics.py:18-21)."""
    return x / y


def fast_linked_ests(w, x, y, z):
    """Elementwise w/x - y*z (reference numerics.py:24-29)."""
    return w / x - y * z


def fast_likelihood(post_means, post_vars, scaled_mu, scaled_ld_diags,
                    linked_ests, adj_marginal, chi_stat, ld_ranks,
                    error_scaling):
    """Expected log likelihood of the RSS model (numerics.py:31-46).

    All [P, I] inputs reduce over I (psum across shards when I is sharded)
    into per-population scalars, then combine with chi_stat/ld_ranks.
    """
    per_pop = jnp.sum(
        -0.5 * (scaled_ld_diags * post_vars + linked_ests * scaled_mu)
        + post_means * adj_marginal,
        axis=1,
    )
    per_pop = per_pop - 0.5 * chi_stat
    return jnp.sum(per_pop / error_scaling
                   - 0.5 * ld_ranks * jnp.log(error_scaling))


def fast_posterior_mean(vi_mu, vi_delta):
    """Mixture-weighted mean (numerics.py:49-57, einsum('kpi,ik->pi')).

    vi_delta is stored K-major ([K, I], the transpose of the reference's
    [I, K]) so that the long SNP axis is the minor (contiguous) one and
    every K-reduction reads whole rows. All [*, K] genome arrays follow
    the same convention."""
    return jnp.einsum('kpi,ki->pi', vi_mu, vi_delta)


def fast_pmv(mean, vi_mu, vi_delta, vi_sigma_diag):
    """Posterior marginal variance E[beta^2] - E[beta]^2 (numerics.py:60-65).

    vi_sigma_diag: [K, P, I] diagonal of the variational covariances
    (the reference's einsum('kppi->kpi', vi_sigma)).
    """
    second_moment = jnp.einsum('kpi,ki->pi', vi_sigma_diag + vi_mu ** 2,
                               vi_delta)
    return second_moment - mean ** 2


def fast_inner_product_comp(vi_mu, mixture_prec, vi_delta):
    """0.5 * einsum('kpi,kqi,kqp,ik->') (numerics.py:98-115)."""
    quad = jnp.einsum('kpi,kqi,kqp->ki', vi_mu, vi_mu, mixture_prec)
    return 0.5 * jnp.einsum('ki,ki->', quad, vi_delta)


def sum_annotations(deltas, annotations, num_annotations):
    """Segment-sum of vi_delta rows by annotation id (numerics.py:118-129).

    deltas: [K, I]; returns [A, K]. Padding SNPs (annotation id ==
    num_annotations, used when the SNP axis is padded for even mesh
    sharding) accumulate into an extra segment that is dropped, so they
    never perturb the real sums. Expressed as a one-hot contraction
    rather than a segment-sum over the K-major layout."""
    one_hot = (annotations[:, None]
               == jnp.arange(num_annotations + 1)[None, :])
    out = jnp.einsum('ki,ia->ak', deltas,
                     one_hot.astype(deltas.dtype))
    return out[:num_annotations]


def fast_delta_kl(vi_delta, hyper_delta, annotations):
    """sum_i vi_delta[i] . (log vi_delta[i] - log hyper_delta[a_i])
    (numerics.py:132-141). vi_delta: [K, I]. Padding SNPs (annotation
    id == num rows of hyper_delta) contribute zero.

    The per-SNP hyper term avoids a [K,A]->[K,I] axis-1 gather, whose
    K-minor layout preference can propagate through the whole fused
    vi_delta cluster. Instead project logh.T @ vi_delta once ([A,I], a
    matmul) and pick each SNP's annotation row with A masked selects."""
    A = hyper_delta.shape[0]
    entropy = jnp.sum(vi_delta * jnp.log(vi_delta), axis=0)     # [I]
    proj = jnp.log(hyper_delta) @ vi_delta                      # [A, I]
    hyper_term = 0.
    for a in range(A):
        hyper_term = hyper_term + jnp.where(annotations == a,
                                            proj[a], 0.0)
    return jnp.sum(jnp.where(annotations < A,
                             entropy - hyper_term, 0.0))


def fast_beta_kl(sigma_summary, vi_delta):
    """0.5 * sum(sigma_summary * vi_delta) (numerics.py:144-146).

    sigma_summary: [K, I] covariance-only KL terms (models.sigma)."""
    return 0.5 * jnp.sum(sigma_summary * vi_delta)


def fast_vi_delta_grad(hyper_delta, log_det, annotations):
    """Natural parameter of the prior-only vi_delta (numerics.py:149-164).

    Returns [K-1, I]: (log hyper[a_i, k] - 0.5 log_det[k]) minus the
    last-component baseline.
    """
    A = hyper_delta.shape[0]
    scores = jnp.log(hyper_delta) - 0.5 * log_det          # [A, K]
    nat = scores[:, :-1] - scores[:, -1:]                  # [A, K-1]
    # A masked broadcasts instead of a [K-1,A]->[K-1,I] axis-1 gather
    # (same layout-poisoning gather as in fast_delta_kl; see there)
    out = jnp.broadcast_to(nat.T[:, -1:],
                           (nat.shape[1], annotations.shape[0]))
    for a in range(A - 1):
        out = jnp.where(annotations[None, :] == a, nat.T[:, a:a + 1], out)
    return out


def map_to_nat_cat_2D(probs):
    """log(probs[k] / probs[-1]) for k < K-1 (numerics.py:167-176).

    probs: [K, I] -> [K-1, I]."""
    logp = jnp.log(probs)
    return logp[:-1] - logp[-1:]


def invert_nat_cat_2D(nat_probs):
    """Stabilized softmax-with-implicit-last-zero, clamped at epsilon
    (numerics.py:179-195). nat_probs: [K-1, I] -> probs [K, I]."""
    eps = epsilon(nat_probs.dtype)
    # initial=0 matches the reference's max(max(row), 0) and also covers
    # the degenerate single-component family (K-1 == 0 rows)
    max_p = jnp.max(nat_probs, axis=0, keepdims=True, initial=0.0)
    expd = jnp.exp(nat_probs - max_p)                      # [K-1, I]
    last = jnp.exp(-max_p)                                 # [1, I]
    denom = last + jnp.sum(expd, axis=0, keepdims=True)
    probs = jnp.concatenate([expd, last], axis=0) / denom
    return jnp.maximum(probs, eps)


def fast_invert_nat_vi_delta(new_mu, nat_mu, const_part, nat_vi_delta):
    """Closed-form vi_delta from natural parameters (numerics.py:198-213).

    new_mu, nat_mu: [K, P, I]; const_part: [K, I] (vi_sigma log-dets);
    nat_vi_delta: [K-1, I]. The quadratic forms mu.nat_mu per component are
    differenced against the last component and fed through the stabilized
    categorical inversion. This chain fuses into a single elementwise+reduce
    kernel under XLA (the reference's hottest fused kernel — SURVEY.md 7.3.4).
    """
    quad = jnp.einsum('kpi,kpi->ki', new_mu, nat_mu)       # [K, I]
    addenda = const_part + quad
    to_invert = 0.5 * (addenda[:-1] - addenda[-1:]) + nat_vi_delta
    return invert_nat_cat_2D(to_invert)
