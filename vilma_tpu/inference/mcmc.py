"""NUTS and annealed-SMC posterior sampling on small LD blocks.

Validation tooling (NUTS/SMC posterior checks on small blocks against
VI output): draws exact-model posterior samples
of the true effects beta for one dense LD block under the same RSS
likelihood + mixture-of-Gaussians prior the VI engine optimizes, so the
variational posterior can be checked against asymptotically exact
samples. Runs host-side on small dense blocks (n_snps x num_pops up to a
few hundred dimensions); gradients via jax autodiff.

Model (per population p, reference variational_inference.py:79-84):
    beta_hat_p ~ N(S_p X S_p^{-1} beta_p, tau_p * S_p X S_p)
prior per SNP i (annotation a_i):
    beta_i ~ sum_k hyper_delta[a_i, k] N(0, mixture_covs[k])
The mixture assignment z_i is marginalized, leaving a differentiable
log-density for NUTS.
"""
import numpy as np
import jax
import jax.numpy as jnp


def make_block_log_posterior(ld_block, betas, std_errs, mixture_covs,
                             weights, annotations, error_scaling=None):
    """Return logpost(beta[P, n]) for one dense LD block.

    Args:
        ld_block: [n, n] dense LD (may be rank-deficient; a pseudo-inverse
            Gaussian density on the LD row space is used, matching the
            reference's projected likelihood).
        betas: [P, n] observed marginal effects.
        std_errs: [P, n].
        mixture_covs: [K, P, P].
        weights: [A, K] mixture weights per annotation.
        annotations: [n] int annotation ids.
        error_scaling: [P] (defaults to ones).
    """
    ld_block = jnp.asarray(ld_block)
    betas = jnp.asarray(betas)
    std_errs = jnp.asarray(std_errs)
    mixture_covs = jnp.asarray(mixture_covs)
    weights = jnp.asarray(weights)
    annotations = jnp.asarray(annotations)
    P, n = betas.shape
    if error_scaling is None:
        error_scaling = jnp.ones(P, dtype=betas.dtype)

    # pseudo-inverse factorization of X for the (possibly singular)
    # Gaussian likelihood on the row space of X
    s_vals, vecs = jnp.linalg.eigh(ld_block)
    keep = s_vals > 1e-10
    s_safe = jnp.where(keep, s_vals, 1.0)

    prec_k = jnp.linalg.inv(mixture_covs)              # [K, P, P]
    _, logdet_k = jnp.linalg.slogdet(mixture_covs)
    log_norm_k = -0.5 * (P * jnp.log(2 * jnp.pi) + logdet_k)   # [K]

    def log_prior(beta):
        # beta: [P, n] -> sum_i logsumexp_k(log w[a_i,k] + logN(beta_i;0,S_k))
        quad = jnp.einsum('pi,kpq,qi->ki', beta, prec_k, beta)   # [K, n]
        comp = log_norm_k[:, None] - 0.5 * quad                  # [K, n]
        logw = jnp.log(weights)[annotations].T                   # [K, n]
        return jnp.sum(jax.scipy.special.logsumexp(comp + logw, axis=0))

    def log_lik(beta):
        # beta_hat ~ N(S X S^{-1} beta, tau S X S); z-space:
        # z_obs = beta_hat / S ~ N(X (beta/S), tau X); project onto the
        # eigenbasis of X: u_j' z_obs ~ N(s_j u_j'(beta/S), tau s_j)
        total = 0.0
        for p in range(P):
            z_obs = betas[p] / std_errs[p]
            z_mu = beta[p] / std_errs[p]
            proj_obs = vecs.T @ z_obs                  # [n]
            proj_mu = s_vals * (vecs.T @ z_mu)
            var = error_scaling[p] * s_safe
            ll = jnp.where(
                keep,
                -0.5 * ((proj_obs - proj_mu) ** 2 / var
                        + jnp.log(2 * jnp.pi * var)),
                0.0)
            total = total + jnp.sum(ll)
        return total

    def log_post(beta):
        return log_lik(beta) + log_prior(beta)

    return log_post


# ---------------------------------------------------------------------------
# NUTS (Hoffman & Gelman 2014, multinomial variant) — recursive build-tree
# on the host with jax-compiled gradient evaluations; intended for small
# validation problems, not production sampling.
# ---------------------------------------------------------------------------

def nuts_sample(log_post, init, num_samples=1000, num_warmup=500, seed=0,
                max_depth=8, target_accept=0.8):
    """Run NUTS; returns samples [num_samples, *init.shape]."""
    rng = np.random.default_rng(seed)
    shape = np.shape(init)
    dim = int(np.prod(shape))

    lp_flat = jax.jit(lambda q: log_post(q.reshape(shape)))
    grad_flat = jax.jit(jax.grad(lambda q: log_post(q.reshape(shape))))

    def logp(q):
        return float(lp_flat(jnp.asarray(q)))

    def grad(q):
        return np.asarray(grad_flat(jnp.asarray(q)))

    def leapfrog(q, p, eps):
        p = p + 0.5 * eps * grad(q)
        q = q + eps * p
        p = p + 0.5 * eps * grad(q)
        return q, p

    def find_reasonable_eps(q):
        eps = 1.0
        p = rng.standard_normal(dim)
        h0 = logp(q) - 0.5 * p @ p
        q1, p1 = leapfrog(q, p, eps)
        h1 = logp(q1) - 0.5 * p1 @ p1
        a = 1.0 if h1 - h0 > np.log(0.5) else -1.0
        for _ in range(50):
            eps *= 2.0 ** a
            q1, p1 = leapfrog(q, p, eps)
            h1 = logp(q1) - 0.5 * p1 @ p1
            if not np.isfinite(h1):
                h1 = -np.inf
            if a * (h1 - h0) <= -a * np.log(2):
                break
        return eps

    q = np.asarray(init, dtype=np.float64).reshape(-1).copy()
    eps = find_reasonable_eps(q)
    # dual averaging (Hoffman & Gelman alg. 6)
    mu = np.log(10 * eps)
    log_eps_bar, h_bar = 0.0, 0.0
    gamma, t0, kappa = 0.05, 10, 0.75

    samples = np.empty((num_samples, dim))
    DELTA_MAX = 1000.0

    def build_tree(q, p, u_slice, v, depth, h0):
        """Returns (q-, p-, q+, p+, q_prop, n_good, stop, alpha, n_alpha)."""
        if depth == 0:
            q1, p1 = leapfrog(q, p, v * eps)
            h1 = logp(q1) - 0.5 * p1 @ p1
            n_good = int(u_slice <= h1)
            stop = u_slice - DELTA_MAX > h1
            alpha = min(1.0, np.exp(min(0.0, h1 - h0)))
            return q1, p1, q1, p1, q1, n_good, stop, alpha, 1
        (qm, pm, qp, pp, qprop, n1, s1, a1, na1) = build_tree(
            q, p, u_slice, v, depth - 1, h0)
        if not s1:
            if v == -1:
                (qm, pm, _, _, qprop2, n2, s2, a2, na2) = build_tree(
                    qm, pm, u_slice, v, depth - 1, h0)
            else:
                (_, _, qp, pp, qprop2, n2, s2, a2, na2) = build_tree(
                    qp, pp, u_slice, v, depth - 1, h0)
            if n2 > 0 and rng.random() < n2 / max(n1 + n2, 1):
                qprop = qprop2
            span = qp - qm
            s1 = s2 or (span @ pm < 0) or (span @ pp < 0)
            n1 += n2
            a1 += a2
            na1 += na2
        return qm, pm, qp, pp, qprop, n1, s1, a1, na1

    total_iters = num_warmup + num_samples
    for it in range(total_iters):
        p0 = rng.standard_normal(dim)
        h0 = logp(q) - 0.5 * p0 @ p0
        u_slice = h0 + np.log(rng.random())
        qm, pm, qp, pp = q.copy(), p0.copy(), q.copy(), p0.copy()
        q_new = q.copy()
        n, stop, depth = 1, False, 0
        alpha_sum, n_alpha = 0.0, 0
        while not stop and depth < max_depth:
            v = 1 if rng.random() < 0.5 else -1
            if v == -1:
                (qm, pm, _, _, qprop, n2, s2, a2, na2) = build_tree(
                    qm, pm, u_slice, v, depth, h0)
            else:
                (_, _, qp, pp, qprop, n2, s2, a2, na2) = build_tree(
                    qp, pp, u_slice, v, depth, h0)
            if not s2 and rng.random() < n2 / max(n, 1):
                q_new = qprop
            n += n2
            span = qp - qm
            stop = s2 or (span @ pm < 0) or (span @ pp < 0)
            depth += 1
            alpha_sum += a2
            n_alpha += na2
        q = q_new
        # step-size adaptation during warmup
        if it < num_warmup:
            accept_stat = alpha_sum / max(n_alpha, 1)
            m = it + 1
            h_bar = ((1 - 1 / (m + t0)) * h_bar
                     + (target_accept - accept_stat) / (m + t0))
            log_eps = mu - np.sqrt(m) / gamma * h_bar
            w = m ** -kappa
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            eps = float(np.exp(log_eps))
        elif it == num_warmup:
            eps = float(np.exp(log_eps_bar))
        if it >= num_warmup:
            samples[it - num_warmup] = q
    return samples.reshape((num_samples,) + shape)


# ---------------------------------------------------------------------------
# Annealed SMC: prior -> posterior tempering with stratified resampling and
# random-walk Metropolis moves.
# ---------------------------------------------------------------------------

def smc_sample(log_post, log_prior_sample, num_particles=2000,
               num_steps=30, num_mcmc=5, seed=0):
    """Annealed SMC from the prior to log_post.

    Args:
        log_post: target log density fn(beta).
        log_prior_sample: fn(rng, num) -> (samples [num, ...], log_prior fn)
    Returns weighted-resampled particles [num_particles, ...].
    """
    rng = np.random.default_rng(seed)
    particles, log_prior = log_prior_sample(rng, num_particles)
    particles = np.asarray(particles, dtype=np.float64)
    shape = particles.shape[1:]
    flat = particles.reshape(num_particles, -1)

    lp_post = jax.jit(jax.vmap(lambda q: log_post(q.reshape(shape))))
    lp_prior = jax.jit(jax.vmap(lambda q: log_prior(q.reshape(shape))))

    def log_target(lam, q):
        return (1 - lam) * np.asarray(lp_prior(q)) + lam * np.asarray(
            lp_post(q))

    lambdas = np.linspace(0, 1, num_steps + 1)
    for li in range(1, len(lambdas)):
        lam_prev, lam = lambdas[li - 1], lambdas[li]
        inc = (lam - lam_prev) * (np.asarray(lp_post(flat))
                                  - np.asarray(lp_prior(flat)))
        w = np.exp(inc - inc.max())
        w /= w.sum()
        # stratified resampling
        positions = (rng.random() + np.arange(num_particles)) / num_particles
        idx = np.searchsorted(np.cumsum(w), positions)
        flat = flat[np.minimum(idx, num_particles - 1)]
        # random-walk MH at tempered target
        step = 0.1 * flat.std(axis=0, keepdims=True) + 1e-8
        cur_lp = log_target(lam, flat)
        for _ in range(num_mcmc):
            prop = flat + step * rng.standard_normal(flat.shape)
            prop_lp = log_target(lam, prop)
            accept = np.log(rng.random(num_particles)) < prop_lp - cur_lp
            flat[accept] = prop[accept]
            cur_lp[accept] = prop_lp[accept]
    return flat.reshape((num_particles,) + shape)


def mixture_prior_sampler(mixture_covs, weights, annotations, num_pops):
    """Prior sampler + log density for `smc_sample`."""
    mixture_covs = np.asarray(mixture_covs)
    weights = np.asarray(weights)
    annotations = np.asarray(annotations)
    n = annotations.shape[0]
    chols = np.linalg.cholesky(mixture_covs)

    prec_k = jnp.linalg.inv(jnp.asarray(mixture_covs))
    _, logdet_k = jnp.linalg.slogdet(jnp.asarray(mixture_covs))
    log_norm_k = -0.5 * (num_pops * jnp.log(2 * jnp.pi) + logdet_k)
    logw = jnp.log(jnp.asarray(weights))[jnp.asarray(annotations)].T

    def log_prior(beta):
        quad = jnp.einsum('pi,kpq,qi->ki', beta, prec_k, beta)
        comp = log_norm_k[:, None] - 0.5 * quad
        return jnp.sum(jax.scipy.special.logsumexp(comp + logw, axis=0))

    def sample(rng, num):
        out = np.zeros((num, num_pops, n))
        for j in range(num):
            ks = np.array([rng.choice(weights.shape[1],
                                      p=weights[annotations[i]])
                           for i in range(n)])
            eps = rng.standard_normal((n, num_pops))
            out[j] = np.einsum('ikp,ik->pi'.replace('k', 'q'),
                               chols[ks], eps)
        return out, log_prior

    return sample
