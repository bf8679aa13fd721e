"""Coordinate-ascent variational inference engine, in JAX.

Functionally equivalent to the reference's VIScheme/MultiPopVI
(reference variational_inference.py:27-889) but redesigned for XLA:

  * VI state is a pytree; one pure jitted `outer_step(data, state)` performs
    a full coordinate-ascent iteration (beta natural-gradient updates with
    backtracking line search, hyper-delta closed form, optional
    error-scaling EM) — the reference's nested Python loops become
    lax.while_loop with scalar predicates, so the whole iteration fuses and
    runs on-device with no host round-trips;
  * the variational covariances vi_sigma are never materialized
    (vilma_tpu.models.sigma closed forms);
  * all [*, I] arrays may be sharded over a device mesh; reductions become
    psums and every control-flow predicate is a function of globally reduced
    scalars, so multi-host executions cannot diverge (SURVEY.md 7.3.3).

Numerical-error handling: the reference raises RuntimeError when the line
search exhausts L > L_MAX with inconsistent objectives
(variational_inference.py:790-798); under jit we set an error flag in the
state and raise host-side after the step.
"""
import dataclasses
import logging
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from vilma_tpu.ops import blocks as blocks_mod
from vilma_tpu.ops import kernels
from vilma_tpu.parallel.distributed import host_fetch as _fetch
from vilma_tpu.models import sigma as sigma_mod
from vilma_tpu.utils.config import epsilon

# Optimization constants (reference variational_inference.py:18-24)
L_MAX = 1e12
REL_TOL = 1e-6
ABS_TOL = 1e-6
ELBO_TOL = 0.1
EM_TOL = 10
ELBO_MOMENTUM = 0.5
MAX_NUM_ITERS = 20


@dataclass(frozen=True)
class ModelData:
    """Immutable sufficient statistics of the RSS model (one fit problem).

    Mirrors the precomputation in VIScheme.__init__
    (variational_inference.py:96-259)."""
    marginal_effects: jnp.ndarray      # [P, I] (scaled if `scaled`)
    std_errs: jnp.ndarray              # [P, I]
    scalings: jnp.ndarray              # [P, I] to undo --scaled at output
    ld_diags: jnp.ndarray              # [P, I]
    scaled_ld_diags: jnp.ndarray       # [P, I] = std_errs**-2 * ld_diags
    adj_marginal_effects: jnp.ndarray  # [P, I]
    chi_stat: jnp.ndarray              # [P]
    ld_ranks: jnp.ndarray              # [P]
    inverse_betas: jnp.ndarray         # [P, I] LDpred-inf init
    annotations: jnp.ndarray           # [I] int32
    annotation_counts: jnp.ndarray     # [A]
    mixture_prec: jnp.ndarray          # [K, P, P]
    log_det: jnp.ndarray               # [K] prior covariance log-dets
    ld: tuple                          # tuple[PackedLD], UNIQUE matrices
    num_annotations: int
    scale_se: bool
    # population p uses ld[ld_index[p]]. Cohorts sharing one LD matrix
    # (e.g. the benchmark's two populations) must not pass the same
    # tensors as two jit parameters: XLA's compile-time HBM check counts
    # each parameter separately (it cannot know two will alias), which
    # alone is ~6 GB of phantom usage at 6M SNPs.
    ld_index: tuple = ()


jax.tree_util.register_dataclass(
    ModelData,
    data_fields=('marginal_effects', 'std_errs', 'scalings', 'ld_diags',
                 'scaled_ld_diags', 'adj_marginal_effects', 'chi_stat',
                 'ld_ranks', 'inverse_betas', 'annotations',
                 'annotation_counts', 'mixture_prec', 'log_det', 'ld'),
    meta_fields=('num_annotations', 'scale_se', 'ld_index'),
)


@dataclass(frozen=True)
class VIState:
    """All mutable optimization state, as one pytree.

    Two representations share this class:

    * MATERIALIZED (`nat_mu is None`): vi_mu/vi_delta/nat_grad_vi_delta/
      sigma hold the full per-SNP arrays — the general path, used when
      the closed-form sigma algebra does not cover P (P >= 4).
    * COMPACT (`nat_mu` set, the big fields None): the whole beta family
      is carried as its natural mean(s). The natural gradient is
      constant in K (reference variational_inference.py:804-823 broadcasts
      a [P, I] residual), and every update between error-scaling EM
      events mixes natural means with K-constant steps, so for
      non-scale_se fits vi_mu[k] == vi_sigma[k] @ nat_mu for ONE shared
      [P, I] nat_mu throughout the trajectory. scale_se fits carry a
      per-component [K, P, I] nat_mu instead: each EM event re-bases it
      under the new scaling ((prec_k + d_new) @ sigma_old_k @ nat_k, see
      `_update_error_scaling_compact`), which is k-dependent but still
      one closed-form pass. Either way vi_delta and every vi_sigma
      summary are closed forms of (nat_mu, hyper_delta, error_scaling).
      Deriving them lazily inside each fused evaluation cuts per-iteration
      HBM traffic from O(K*P*I) state reads/writes per pass to O(P*I)
      (non-scale_se; measured 40.3 GB -> a few GB per outer step at
      I=1M, K=18) or one [K, P, I] stream (scale_se), with no [K, I]
      sigma summaries ever stored.
    """
    vi_mu: jnp.ndarray            # [K, P, I] (None in compact mode)
    vi_delta: jnp.ndarray         # [K, I] (K-major; the reference's
    #   vi_delta is its [I, K] transpose — see kernels.fast_posterior_mean
    #   for the layout rationale; .npz checkpoints keep [I, K])
    hyper_delta: jnp.ndarray      # [A, K]
    error_scaling: jnp.ndarray    # [P]
    nat_grad_vi_delta: jnp.ndarray  # [K-1, I] (None in compact mode)
    sigma: sigma_mod.SigmaSummaries   # (None in compact mode)
    L: jnp.ndarray                # [3] per-paramset Lipschitz estimates
    elbo: jnp.ndarray             # scalar (tracked via deltas)
    running_elbo_delta: jnp.ndarray  # scalar; nan = not yet initialized
    num_err: jnp.ndarray          # int32 count of line-search failures
    nat_mu: jnp.ndarray = None    # [P, I] compact natural mean, or None
    # EPOCH-HISTORY scale_se representation (sigma.compact_exprs_epochs):
    # when nat_hist is set, nat_mu is the [P, I] CURRENT-epoch
    # accumulator and the per-component state is implied by the history
    # — O(E*P*I) memory where the kdim state would be O(K*P*I) (26 GiB
    # at 6M SNPs with the production grid). Buffer slots >= nat_hist_n
    # are inert (nat_hist_c == 0 there).
    nat_hist: jnp.ndarray = None        # [B, P, I] epoch vectors
    nat_hist_scale: jnp.ndarray = None  # [B, P] error_scaling per epoch
    nat_hist_c: jnp.ndarray = None      # [B] coefficients
    nat_hist_n: jnp.ndarray = None      # int32 live epoch count


jax.tree_util.register_dataclass(
    VIState,
    data_fields=('vi_mu', 'vi_delta', 'hyper_delta', 'error_scaling',
                 'nat_grad_vi_delta', 'sigma', 'L', 'elbo',
                 'running_elbo_delta', 'num_err', 'nat_mu', 'nat_hist',
                 'nat_hist_scale', 'nat_hist_c', 'nat_hist_n'),
    meta_fields=(),
)

# EM re-basings whose relative error-scaling change is below this are
# treated as converged (no epoch appended, scaling frozen) — 1e-6 is
# the f32 noise floor; the f64 parity tests pin exactness with 0.0
_EPOCH_SKIP_TOL = 1e-6
# epoch-buffer growth buckets (recompile points) and the hard cap; at
# the cap further EM updates freeze with a warning
_EPOCH_BUCKETS = (4, 8, 16, 32, 48)
_EPOCH_CAP = _EPOCH_BUCKETS[-1]
# scale_se fits whose kdim [K, P, I] state would exceed this use the
# epoch representation instead (the kdim fast path keeps small states);
# VILMA_EPOCH_STATE_BYTES overrides (0 forces epoch mode everywhere)
import os as _os
_EPOCH_STATE_BYTES = int(_os.environ.get('VILMA_EPOCH_STATE_BYTES',
                                         1 << 30))


def _isclose(a, b, rtol=1e-5, atol=1e-8):
    return jnp.abs(a - b) <= atol + rtol * jnp.abs(b)


def _err_rtol(dtype):
    """Tolerance for the line-search "inconsistent objectives" guard.

    The reference compares with np.isclose defaults (rtol=1e-5) in f64
    (variational_inference.py:790-798): when even a ~1e-12 step cannot
    reproduce the original objective, something has genuinely diverged.
    On the f32/bf16 fast path the objective is a 1e5..1e7-term reduction
    evaluated by two *differently fused* XLA programs (the standalone
    evaluation that produced orig_obj vs the line-search loop body), so
    the two values legitimately differ by cross-program rounding noise —
    relative ~1e-4 was observed at the 100K-SNP scale, which spuriously
    raised 'Encountered a numerical error' on a healthy f32 fit. A 1e-3
    band still catches real divergence (orders of magnitude, NaN) while
    tolerating evaluation noise; f64 keeps the reference's exact guard.
    """
    return 1e-5 if np.dtype(dtype) == np.float64 else 1e-3


def _diag_term(data, error_scaling):
    return data.scaled_ld_diags / error_scaling[:, None]


# ---------------------------------------------------------------------------
# ELBO terms
# ---------------------------------------------------------------------------

def posterior_mean(vi_mu, vi_delta):
    return kernels.fast_posterior_mean(vi_mu, vi_delta)


def posterior_marginal_variance(mean, vi_mu, vi_delta, sigma):
    return kernels.fast_pmv(mean, vi_mu, vi_delta, sigma.diag)


def _ld_scaled_dot(data, post_means):
    """linked = LD . (post_means / SE) for each population — the hot block
    matvec (variational_inference.py:459,812).

    Populations sharing an LD matrix (ModelData.ld_index) are batched
    into ONE multi-RHS pass (blocks.dot_multi), so the dominant U
    tensors stream from device memory once instead of once per cohort.
    Traced under the 'ld_matvec' scope."""
    with jax.named_scope('ld_matvec'):
        scaled_mu = post_means / data.std_errs
        P = scaled_mu.shape[0]
        outs = [None] * P
        for m in range(len(data.ld)):
            pops = [p for p in range(P) if data.ld_index[p] == m]
            if len(pops) == 1:
                outs[pops[0]] = blocks_mod.dot(data.ld[m],
                                               scaled_mu[pops[0]])
            elif pops:
                ys = blocks_mod.dot_multi(data.ld[m],
                                          scaled_mu[jnp.array(pops)])
                for j, p in enumerate(pops):
                    outs[p] = ys[j]
        return scaled_mu, jnp.stack(outs)


def log_likelihood_terms(data, sigma, error_scaling, vi_mu, vi_delta):
    """Expected log likelihood plus its reusable intermediates
    (variational_inference.py:452-470). Returns (ll, post_means, linked)
    where linked = LD.(post/SE); the natural gradient and the EM update
    consume the same matvec (variational_inference.py:804-823,472-486), so
    callers thread it through instead of recomputing."""
    post_means = posterior_mean(vi_mu, vi_delta)
    post_vars = posterior_marginal_variance(post_means, vi_mu, vi_delta,
                                            sigma)
    scaled_mu, linked_ests = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(post_means, post_vars, scaled_mu,
                                 data.scaled_ld_diags, linked_ests,
                                 data.adj_marginal_effects, data.chi_stat,
                                 data.ld_ranks, error_scaling)
    return ll, post_means, linked_ests


def log_likelihood(data, sigma, error_scaling, vi_mu, vi_delta):
    """Expected log likelihood (variational_inference.py:452-470)."""
    return log_likelihood_terms(data, sigma, error_scaling, vi_mu,
                                vi_delta)[0]


def beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta):
    """KL of the effect-size VI family (variational_inference.py:873-885).

    SNP-axis padding slots (annotation id == num_annotations, see
    parallel/padding.py) are masked out of the covariance term; they are
    already inert in the other two terms (vi_mu is 0 there and
    fast_delta_kl masks internally)."""
    delta_comp = kernels.fast_delta_kl(vi_delta, hyper_delta,
                                       data.annotations)
    inner = kernels.fast_inner_product_comp(vi_mu, data.mixture_prec,
                                            vi_delta)
    real = (data.annotations < data.num_annotations)[None, :]
    fast_comp = 0.5 * jnp.sum(
        jnp.where(real, sigma.sigma_summary * vi_delta, 0.0))
    return delta_comp + inner + fast_comp


def elbo(data, sigma, error_scaling, vi_mu, vi_delta, hyper_delta):
    """Evidence lower bound (variational_inference.py:412-417; the
    annotation KL is identically 0 in MultiPopVI)."""
    return (log_likelihood(data, sigma, error_scaling, vi_mu, vi_delta)
            - beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta))


def _beta_objective(data, sigma, error_scaling, vi_mu, vi_delta,
                    hyper_delta):
    """ELBO terms involving the beta VI family
    (variational_inference.py:488-490)."""
    return (log_likelihood(data, sigma, error_scaling, vi_mu, vi_delta)
            - beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta))


def _beta_objective_terms(data, sigma, error_scaling, vi_mu, vi_delta,
                          hyper_delta):
    """(beta objective, post_means, linked) — objective plus the reusable
    matvec intermediates. Note the beta objective equals the full ELBO in
    MultiPopVI (annotation KL is 0), so this also serves elbo callers."""
    ll, post_means, linked = log_likelihood_terms(
        data, sigma, error_scaling, vi_mu, vi_delta)
    obj = ll - beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta)
    return obj, post_means, linked


elbo_jit = jax.jit(
    lambda data, sigma, error_scaling, vi_mu, vi_delta, hyper_delta:
    elbo(data, sigma, error_scaling, vi_mu, vi_delta, hyper_delta))


def _minimal_state(error_scaling, nat_mu, hyper_delta, nat_hist=None,
                   nat_hist_scale=None, nat_hist_c=None,
                   nat_hist_n=None):
    """A VIState carrying only what the compact/epoch objective reads."""
    return VIState(vi_mu=None, vi_delta=None, hyper_delta=hyper_delta,
                   error_scaling=error_scaling, nat_grad_vi_delta=None,
                   sigma=None, L=None, elbo=None,
                   running_elbo_delta=None, num_err=None, nat_mu=nat_mu,
                   nat_hist=nat_hist, nat_hist_scale=nat_hist_scale,
                   nat_hist_c=nat_hist_c, nat_hist_n=nat_hist_n)


@jax.jit
def elbo_compact_jit(data, error_scaling, nat_mu, hyper_delta):
    """ELBO of a compact state.

    Routed through `_objective_compact` (the beta objective equals the
    full ELBO in MultiPopVI) rather than `_derive_params` + `elbo`: the
    derive route materializes vi_mu/vi_delta as real [K, *, I] arrays,
    which at production mixture grids is tens of GB (582 components x
    6M SNPs = 27.9 GB — observed as a compile-time OOM), while the
    objective route runs the fused prologue / K-fused staging."""
    st = _minimal_state(error_scaling, nat_mu, hyper_delta)
    return _objective_compact(data, st, nat_mu, hyper_delta)[0]


@jax.jit
def elbo_epoch_jit(data, error_scaling, nat_u, hist_v, hist_scale,
                   hist_c, hyper_delta):
    """ELBO of an epoch-history state (see elbo_compact_jit)."""
    st = _minimal_state(error_scaling, nat_u, hyper_delta,
                        nat_hist=hist_v, nat_hist_scale=hist_scale,
                        nat_hist_c=hist_c)
    return _objective_epoch(data, st, nat_u, hist_c, hyper_delta)[0]


@jax.jit
def _scaled_posterior_mean_epoch(data, error_scaling, nat_u, hist_v,
                                 hist_scale, hist_c, hyper_delta):
    st = _minimal_state(error_scaling, nat_u, hyper_delta,
                        nat_hist=hist_v, nat_hist_scale=hist_scale,
                        nat_hist_c=hist_c)
    _, pm, _ = _objective_epoch(data, st, nat_u, hist_c, hyper_delta)
    return pm * data.scalings


@jax.jit
def _scaled_posterior_mean_compact(data, error_scaling, nat_mu,
                                   hyper_delta):
    """Posterior mean of a compact state, without materializing the
    [K, *, I] derived family (see elbo_compact_jit; the extra LD matvec
    the objective route performs only runs at init/checkpoint
    boundaries)."""
    st = _minimal_state(error_scaling, nat_mu, hyper_delta)
    _, pm, _ = _objective_compact(data, st, nat_mu, hyper_delta)
    return pm * data.scalings


def nat_to_not_vi_delta(data, sigma, error_scaling, vi_mu,
                        nat_grad_vi_delta):
    """Closed-form vi_delta from current natural parameters
    (variational_inference.py:632-641)."""
    dterm = _diag_term(data, error_scaling)
    nat_mu = sigma_mod.apply_precision(data.mixture_prec, dterm, vi_mu)
    return kernels.fast_invert_nat_vi_delta(
        vi_mu, nat_mu, sigma.log_det_sigma, nat_grad_vi_delta)


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

def _nat_grad_resid(data, error_scaling, post_mean, linked_raw):
    """The [P, I] natural-gradient residual (constant across mixture
    components — the structural fact the compact representation exploits)."""
    linked = kernels.fast_linked_ests(linked_raw, data.std_errs, post_mean,
                                      data.scaled_ld_diags)
    return (data.adj_marginal_effects - linked) / error_scaling[:, None]


def _nat_grad_beta(data, error_scaling, post_mean, linked_raw):
    """Natural gradient for the beta family
    (variational_inference.py:804-823). Takes the posterior mean and the
    raw matvec linked_raw = LD.(post_mean/SE) already computed by the
    objective evaluation of the same parameters (exact reuse — the
    reference recomputes them). Returns [K, P, I] (constant in K)."""
    resid = _nat_grad_resid(data, error_scaling, post_mean, linked_raw)
    K = data.mixture_prec.shape[0]
    return jnp.broadcast_to(resid[None], (K,) + resid.shape)


def _update_beta(data, st, orig_obj, cur_post_mean, cur_linked,
                 line_search_rate):
    """One natural-gradient step with backtracking line search
    (variational_inference.py:762-802).

    cur_post_mean/cur_linked are the posterior mean and LD.(mean/SE) of the
    CURRENT params (already computed by whichever objective evaluation
    produced orig_obj) — reused for the natural gradient, exactly as the
    values the reference recomputes at variational_inference.py:807-812.

    Returns (vi_mu, vi_delta, L0, new_obj, post_mean, linked, err_inc)
    where post_mean/linked correspond to the returned params."""
    dterm = _diag_term(data, st.error_scaling)
    old_nat_mu = sigma_mod.apply_precision(data.mixture_prec, dterm,
                                           st.vi_mu)
    nat_grad_mu = _nat_grad_beta(data, st.error_scaling, cur_post_mean,
                                 cur_linked)
    const_part = st.sigma.log_det_sigma

    def trial(L0):
        step_size = 1. / L0
        nat_mu = kernels.sum_betas(old_nat_mu, nat_grad_mu, step_size)
        new_mu = sigma_mod.apply_sigma(data.mixture_prec, dterm, nat_mu)
        new_vd = kernels.fast_invert_nat_vi_delta(
            new_mu, nat_mu, const_part, st.nat_grad_vi_delta)
        new_obj, pm, lk = _beta_objective_terms(
            data, st.sigma, st.error_scaling, new_mu, new_vd,
            st.hyper_delta)
        return new_mu, new_vd, new_obj, pm, lk

    threshold = orig_obj - REL_TOL * jnp.abs(orig_obj) - ABS_TOL

    def cond(carry):
        L0, _, _, new_obj, _, _ = carry
        return jnp.logical_and(new_obj < threshold, L0 <= L_MAX)

    def body(carry):
        L0 = carry[0]
        L_next = L0 * line_search_rate
        return (L_next,) + trial(L_next)

    L0 = st.L[0]
    init = (L0,) + trial(L0)
    L0, new_mu, new_vd, new_obj, pm, lk = jax.lax.while_loop(cond, body,
                                                             init)

    accepted = new_obj >= threshold
    err = jnp.logical_and(
        L0 > L_MAX,
        jnp.logical_not(_isclose(orig_obj, new_obj,
                                 rtol=_err_rtol(new_obj.dtype))))
    vi_mu = jnp.where(accepted, new_mu, st.vi_mu)
    vi_delta = jnp.where(accepted, new_vd, st.vi_delta)
    post_mean = jnp.where(accepted, pm, cur_post_mean)
    linked = jnp.where(accepted, lk, cur_linked)
    new_obj = jnp.where(accepted, new_obj, orig_obj)
    return vi_mu, vi_delta, L0, new_obj, post_mean, linked, err.astype(
        jnp.int32)


def _beta_loop(data, st, conv_tol, line_search_rate):
    """Up to MAX_NUM_ITERS beta updates (variational_inference.py:427-439),
    stopping once the objective gain is below conv_tol or L hits its
    bounds. Returns (state, objective delta, final objective, post_mean,
    linked) — the final objective value and matvec intermediates feed the
    hyper-delta update, which would otherwise recompute them
    (the beta objective == the full ELBO here).

    Only the fields the loop actually mutates (vi_mu, vi_delta, L0,
    num_err) travel in the while carry; everything else (the sigma
    summaries, hyper_delta, nat_grad_vi_delta — tens of MB at genome
    scale) is closed over, so XLA never materializes it across loop
    iterations."""
    obj0, pm0, lk0 = _beta_objective_terms(
        data, st.sigma, st.error_scaling, st.vi_mu, st.vi_delta,
        st.hyper_delta)

    def body(carry):
        vi_mu, vi_delta, L0, num_err, orig_obj, pm, lk, delta, it, _ = carry
        L0 = jnp.maximum(1., L0 / 1.25)
        cur = dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                                  L=st.L.at[0].set(L0))
        vi_mu, vi_delta, L0, new_obj, pm, lk, err = _update_beta(
            data, cur, orig_obj, pm, lk, line_search_rate)
        delta = delta + new_obj - orig_obj
        done = jnp.logical_or(
            jnp.abs(new_obj - orig_obj) <= conv_tol,
            jnp.logical_or(L0 == 1., L0 > L_MAX))
        return (vi_mu, vi_delta, L0, num_err + err, new_obj, pm, lk,
                delta, it + 1, done)

    def cond(carry):
        it, done = carry[8], carry[9]
        return jnp.logical_and(it < MAX_NUM_ITERS, jnp.logical_not(done))

    (vi_mu, vi_delta, L0, num_err, obj, pm, lk, delta, _, _) = (
        jax.lax.while_loop(
            cond, body,
            (st.vi_mu, st.vi_delta, st.L[0], st.num_err, obj0, pm0, lk0,
             jnp.zeros_like(obj0), jnp.asarray(0), jnp.asarray(False))))
    st = dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                             L=st.L.at[0].set(L0), num_err=num_err)
    return st, delta, obj, pm, lk


def _update_hyper_delta(data, st, orig_obj):
    """Closed-form per-annotation mixture-weight update
    (variational_inference.py:825-860). The reference's inner loop always
    exits after one iteration for this paramset (its L stays pinned at 1,
    variational_inference.py:430,436-437), so a single update is exact.
    orig_obj is the ELBO of the current params (the beta loop's final
    objective — identical to the value the reference recomputes at
    variational_inference.py:828-831 since the annotation KL is 0)."""
    eps = epsilon(st.vi_delta.dtype)
    new_hd = kernels.sum_annotations(st.vi_delta, data.annotations,
                                     data.num_annotations)
    new_hd = jnp.maximum(
        new_hd / (data.annotation_counts[:, None] + eps), eps)
    new_hd = new_hd / new_hd.sum(axis=1, keepdims=True)
    nat_grad_vi_delta = kernels.fast_vi_delta_grad(new_hd, data.log_det,
                                                   data.annotations)
    new_vd = nat_to_not_vi_delta(data, st.sigma, st.error_scaling, st.vi_mu,
                                 nat_grad_vi_delta)
    new_obj, pm, lk = _beta_objective_terms(
        data, st.sigma, st.error_scaling, st.vi_mu, new_vd, new_hd)
    st = dataclasses.replace(st, vi_delta=new_vd, hyper_delta=new_hd,
                             nat_grad_vi_delta=nat_grad_vi_delta)
    return st, new_obj - orig_obj, new_obj, pm, lk


def _update_error_scaling(data, st, orig_obj, post_means, linked):
    """EM update of the per-population error scalings + vi_sigma refresh
    (variational_inference.py:441-448,472-486,735-738). orig_obj /
    post_means / linked come from the preceding hyper-delta objective
    evaluation of the same params (exact reuse of the quantities the
    reference recomputes at variational_inference.py:442,475-482 —
    including the LD.(mean/SE) matvec inside the quadratic form)."""
    post_vars = posterior_marginal_variance(post_means, st.vi_mu,
                                            st.vi_delta, st.sigma)
    scaled_mu = post_means / data.std_errs
    quad = jnp.einsum('pi,pi->p', scaled_mu, linked)
    new_scaling = (
        data.chi_stat
        - 2 * jnp.einsum('pi,pi->p', post_means, data.adj_marginal_effects)
        + quad
        + jnp.sum(data.ld_diags * post_vars * data.std_errs ** -2, axis=1)
    ) / data.ld_ranks
    new_sigma = sigma_mod.make_summaries(
        data.mixture_prec, data.log_det, _diag_term(data, new_scaling))
    new_vd = nat_to_not_vi_delta(data, new_sigma, new_scaling, st.vi_mu,
                                 st.nat_grad_vi_delta)
    st = dataclasses.replace(st, error_scaling=new_scaling, sigma=new_sigma,
                             vi_delta=new_vd)
    new_obj = elbo(data, st.sigma, st.error_scaling, st.vi_mu, st.vi_delta,
                   st.hyper_delta)
    return st, new_obj - orig_obj


# ---------------------------------------------------------------------------
# Compact-representation step (see the VIState docstring). Every [K, *, I]
# quantity is re-derived from the natural mean(s) inside the consuming
# fusion, so the per-iteration HBM traffic is O(P*I) plus the LD pass
# (plus one [K, P, I] stream per evaluation for scale_se fits, whose
# error-scaling EM makes the natural means K-dependent — see
# _update_error_scaling_compact for the exact re-basing identity).
# ---------------------------------------------------------------------------

def _nat_k(data, nat_mu):
    """A compact natural mean as [K, P, I]: the shared [P, I] state
    broadcasts; the scale_se per-component [K, P, I] state passes
    through (see sigma._nat_row)."""
    if nat_mu.ndim == 2:
        K = data.mixture_prec.shape[0]
        return jnp.broadcast_to(nat_mu[None], (K,) + nat_mu.shape)
    return nat_mu


def _derive_params(data, error_scaling, nat_mu, hyper_delta):
    """(sigma, vi_mu [K,P,I], vi_delta [K,I]) derived from the compact
    state — traced lazily so XLA fuses the K axis into consumers."""
    dterm = _diag_term(data, error_scaling)
    sigma = sigma_mod.make_summaries(data.mixture_prec, data.log_det,
                                     dterm)
    nat_vd = kernels.fast_vi_delta_grad(hyper_delta, data.log_det,
                                        data.annotations)
    nat_b = _nat_k(data, nat_mu)
    vi_mu = sigma_mod.apply_sigma(data.mixture_prec, dterm, nat_b)
    vi_delta = kernels.fast_invert_nat_vi_delta(
        vi_mu, nat_b, sigma.log_det_sigma, nat_vd)
    return sigma, vi_mu, vi_delta


def _objective_compact(data, st, nat_mu, hyper_delta):
    """(objective, post_means, linked) of a compact parameter point
    (st supplies only error_scaling — `_minimal_state` builds a
    sufficient stand-in for callers outside the step).

    Hand-staged rather than routed through `_derive_params` +
    `_beta_objective_terms`: the generic route leaves XLA free to
    materialize the derived [K,P,I]/[K,I] intermediates between fusions
    (profiled at 1M SNPs: it did, keeping per-evaluation HBM traffic at
    ~6.4 GB). Here every per-component quantity is an inline closed-form
    expression and all K-reductions are siblings over shared producers,
    which XLA multi-output-fuses into a few passes. Same math as the
    materialized path (reference variational_inference.py:452-490,
    632-641, 868-885), identical up to float reassociation.
    """
    if nat_mu.ndim == 2 and _use_chunked(data, nat_mu):
        return _objective_chunked(data, st, nat_mu, hyper_delta)
    with jax.named_scope('prologue'):
        dterm = _diag_term(data, st.error_scaling)
        ex = sigma_mod.compact_exprs(data.mixture_prec, dterm, nat_mu)
    return _objective_from_exprs(data, st.error_scaling, ex, hyper_delta)


def _objective_from_exprs(data, error_scaling, ex, hyper_delta):
    """(objective, post_means, linked) from per-component CompactExprs —
    the XLA-staged evaluation tail shared by the [P, I] compact state
    and the epoch-history scale_se state (`_objective_epoch`).

    vi_delta comes from the compact closed forms: the prior-only natural
    params plus the per-component quadratic/log-det corrections, fed
    through the stabilized categorical inversion (the same jnp kernels
    the materialized path uses; both fuse under jit). The component
    evaluation is traced under the 'prologue' scope."""
    with jax.named_scope('prologue'):
        natvd = kernels.fast_vi_delta_grad(hyper_delta, data.log_det,
                                           data.annotations)  # [K-1, I]
        addenda = ex.log_det_sigma + ex.quad                  # [K, I]
        li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd      # [K-1, I]
        vi_delta = kernels.invert_nat_cat_2D(li)              # [K, I]

        # posterior moments (fast_posterior_mean / fast_pmv)
        post_means = jnp.einsum('kpi,ki->pi', ex.mu, vi_delta)
        second = jnp.einsum('kpi,ki->pi', ex.diag + ex.mu ** 2,
                            vi_delta)
        post_vars = second - post_means ** 2

    # likelihood (one LD pass)
    scaled_mu, linked_ests = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(post_means, post_vars, scaled_mu,
                                 data.scaled_ld_diags, linked_ests,
                                 data.adj_marginal_effects, data.chi_stat,
                                 data.ld_ranks, error_scaling)

    # beta KL (fast_delta_kl + fast_inner_product_comp + fast_beta_kl)
    real = (data.annotations < data.num_annotations)[None, :]
    delta_comp = kernels.fast_delta_kl(vi_delta, hyper_delta,
                                       data.annotations)
    inner = 0.5 * jnp.sum(
        jnp.where(real, ex.quadform * vi_delta, 0.0))
    ss = (data.log_det[:, None] - ex.log_det_sigma + ex.matches)
    cov_comp = 0.5 * jnp.sum(jnp.where(real, ss * vi_delta, 0.0))
    obj = ll - (delta_comp + inner + cov_comp)
    return obj, post_means, linked_ests


# ---------------------------------------------------------------------------
# K-chunked compact evaluation (unbounded mixture-grid size)
#
# The XLA-staged compact routes above materialize [K, I]-shaped
# CompactExprs members; at production grids that is the single-chip
# ceiling (a 3-cohort -K 12 grid has 42,999 PSD components — one
# f32[K, I] buffer is 17 GB at 100K SNPs). But every K-reduction the
# objective needs is a softmax-weighted sum over components, so it can
# be accumulated ONE K-chunk at a time with the online-softmax
# rescaling identity (running max m, running sum s; all accumulators
# rescaled by exp(m_old - m_new) when the max advances). Exact up to
# float reassociation and the epsilon probability clamp
# (kernels.invert_nat_cat_2D clamps vi_delta at ~1e-30 in f32; the
# chunked route uses the pure softmax — the difference is bounded by
# K * eps * max|term|, below evaluation noise). Memory: O(kc * I)
# temporaries + O(P * I) accumulators, independent of K.
# ---------------------------------------------------------------------------

# compact fits whose [K, I] staging buffers would exceed this use the
# K-chunked evaluation; smaller grids stage whole [K, I] CompactExprs.
# VILMA_XLA_KI_CHUNK_BYTES overrides (0 forces chunking everywhere).
_XLA_KI_CHUNK_BYTES = int(_os.environ.get('VILMA_XLA_KI_CHUNK_BYTES',
                                          1 << 30))


def _use_chunked(data, nat_mu):
    K = data.mixture_prec.shape[0]
    I = data.annotations.shape[0]
    itemsize = jnp.dtype(nat_mu.dtype).itemsize
    return K > 128 and K * I * itemsize > _XLA_KI_CHUNK_BYTES


def _chunk_kc(K, I, itemsize):
    """Chunk width: ~8 [kc, I] temporaries per chunk body within the
    chunking budget. kc is the SUBLANE-major axis of the [kc, I] chunk
    tiles (I is on lanes), so a multiple of 8 suffices — a 128 floor
    would blow the budget ~20x at 6M SNPs (8 x 128 x 6M x 4 B = 24 GB
    of scan-body temporaries; measured as a 67 GB compile-time OOM)."""
    kc = max(1, _XLA_KI_CHUNK_BYTES) // (8 * I * itemsize)
    return int(max(8, min(kc // 8 * 8, 4096)))


def _chunked_padded_tables(data, hyper_delta, dtype, kc):
    """(prec, logdet, scores) with K padded to a kc multiple. Padded
    components carry identity precision and a score of finfo.min/2:
    exp(score - m) is exactly 0, and 0 * score stays finite, so they
    are inert in every accumulator."""
    K, P = data.mixture_prec.shape[:2]
    C = -(-K // kc)
    prec = data.mixture_prec
    logdet = data.log_det
    scores = (jnp.log(hyper_delta).astype(dtype)
              - 0.5 * logdet.astype(dtype))                 # [A, K]
    pad = C * kc - K
    if pad:
        prec = jnp.concatenate(
            [prec, jnp.broadcast_to(jnp.eye(P, dtype=prec.dtype)[None],
                                    (pad, P, P))], axis=0)
        logdet = jnp.concatenate(
            [logdet, jnp.zeros(pad, dtype=logdet.dtype)])
        neg = jnp.asarray(jnp.finfo(dtype).min / 2, dtype)
        scores = jnp.concatenate(
            [scores, jnp.full((scores.shape[0], pad), neg, dtype)],
            axis=1)
    return C, prec, logdet, scores


def _chunk_select(table, annotations, I):
    """SEL[k, i] = table[a_i, k] for a [A, kc] chunk table, as A masked
    broadcasts (the axis-1 gather poisons the K-minor layout — see
    kernels.fast_delta_kl); annotations >= A select row A-1, matching
    kernels.fast_vi_delta_grad."""
    A = table.shape[0]
    out = jnp.broadcast_to(table.T[:, A - 1:A], (table.shape[1], I))
    for a in range(A - 1):
        out = jnp.where(annotations[None, :] == a, table.T[:, a:a + 1],
                        out)
    return out


def _chunked_moments(data, st, nat_u, hyper_delta, hist_c=None):
    """Online-softmax K-chunked accumulation of every K-reduction the
    compact objective needs. nat_u is the K-shared [P, I] natural mean
    (plain compact state, hist_c None) or the epoch accumulator (epoch
    state, hist_c set — per-component exprs from the shared history).

    Returns (post_means, post_vars, delta_comp, inner, cov_comp) — the
    same quantities `_objective_from_exprs` derives from materialized
    [K, I] exprs, with O(kc * I) peak memory."""
    dtype = nat_u.dtype
    K, P = data.mixture_prec.shape[:2]
    I = data.annotations.shape[0]
    kc = _chunk_kc(K, I, jnp.dtype(dtype).itemsize)
    C, prec, logdet, scores = _chunked_padded_tables(data, hyper_delta,
                                                     dtype, kc)
    dterm = _diag_term(data, st.error_scaling)
    hist_dt = _hist_dterms(data, st) if hist_c is not None else None
    ann = data.annotations

    def chunk_exprs(c):
        pc = jax.lax.dynamic_slice_in_dim(prec, c * kc, kc, axis=0)
        ldc = jax.lax.dynamic_slice_in_dim(logdet, c * kc, kc, axis=0)
        sc = jax.lax.dynamic_slice_in_dim(scores, c * kc, kc, axis=1)
        if hist_c is not None:
            ex = sigma_mod.compact_exprs_epochs(pc, dterm, nat_u,
                                                st.nat_hist, hist_dt,
                                                hist_c)
        else:
            ex = sigma_mod.compact_exprs(pc, dterm, nat_u)
        selsc = _chunk_select(sc, ann, I)                   # [kc, I]
        r = 0.5 * (ex.log_det_sigma + ex.quad) + selsc      # [kc, I]
        return ex, ldc, selsc, r

    def body(carry, c):
        m, s, pm, sec, qf, ssn, rn, lhn = carry
        ex, ldc, selsc, r = chunk_exprs(c)
        nm = jnp.maximum(m, jnp.max(r, axis=0))
        scale = jnp.exp(m - nm)
        w = jnp.exp(r - nm[None, :])                        # [kc, I]
        sel_lh = selsc + 0.5 * ldc.astype(dtype)[:, None]   # log hyper
        ss = (ldc[:, None] - ex.log_det_sigma + ex.matches)
        return ((nm,
                 s * scale + jnp.sum(w, axis=0),
                 pm * scale[None] + jnp.einsum('kpi,ki->pi', ex.mu, w),
                 sec * scale[None] + jnp.einsum('kpi,ki->pi',
                                                ex.diag + ex.mu ** 2, w),
                 qf * scale + jnp.sum(ex.quadform * w, axis=0),
                 ssn * scale + jnp.sum(ss * w, axis=0),
                 rn * scale + jnp.sum(r * w, axis=0),
                 lhn * scale + jnp.sum(sel_lh * w, axis=0)), None)

    zi = jnp.zeros(I, dtype=dtype)
    zpi = jnp.zeros((P, I), dtype=dtype)
    init = (jnp.full(I, -jnp.inf, dtype=dtype), zi, zpi, zpi, zi, zi,
            zi, zi)
    (m, s, pm, sec, qf, ssn, rn, lhn), _ = jax.lax.scan(
        body, init, jnp.arange(C))

    inv_s = 1.0 / s
    post_means = pm * inv_s[None]
    post_vars = sec * inv_s[None] - post_means ** 2
    real = ann < data.num_annotations
    # sum_k w_k log w_k = (sum_k w_k r_k)/s - (m + log s); the hyper
    # term is (sum_k w_k log hyper[a_i, k])/s (fast_delta_kl semantics)
    ent_minus_hyper = rn * inv_s - m - jnp.log(s) - lhn * inv_s
    delta_comp = jnp.sum(jnp.where(real, ent_minus_hyper, 0.0))
    inner = 0.5 * jnp.sum(jnp.where(real, qf * inv_s, 0.0))
    cov_comp = 0.5 * jnp.sum(jnp.where(real, ssn * inv_s, 0.0))
    return post_means, post_vars, delta_comp, inner, cov_comp


def _objective_chunked(data, st, nat_u, hyper_delta, hist_c=None):
    """(objective, post_means, linked) via `_chunked_moments` — the
    K-chunked twin of `_objective_from_exprs`."""
    with jax.named_scope('prologue'):
        post_means, post_vars, delta_comp, inner, cov_comp = \
            _chunked_moments(data, st, nat_u, hyper_delta, hist_c=hist_c)
    scaled_mu, linked_ests = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(post_means, post_vars, scaled_mu,
                                 data.scaled_ld_diags, linked_ests,
                                 data.adj_marginal_effects,
                                 data.chi_stat, data.ld_ranks,
                                 st.error_scaling)
    return ll - (delta_comp + inner + cov_comp), post_means, linked_ests


def _delta_sums_chunked(data, st, nat_u, hyper_delta, hist_c=None):
    """sum_annotations of the derived vi_delta, K-chunked: pass 1 runs
    the online-softmax scan for (m, s); pass 2 re-derives each chunk's
    weights and accumulates the [A, kc] segment sums."""
    dtype = nat_u.dtype
    K, P = data.mixture_prec.shape[:2]
    I = data.annotations.shape[0]
    A = data.num_annotations
    kc = _chunk_kc(K, I, jnp.dtype(dtype).itemsize)
    C, prec, logdet, scores = _chunked_padded_tables(data, hyper_delta,
                                                     dtype, kc)
    dterm = _diag_term(data, st.error_scaling)
    hist_dt = _hist_dterms(data, st) if hist_c is not None else None
    ann = data.annotations
    one_hot = (ann[:, None] == jnp.arange(A + 1)[None, :]).astype(dtype)

    def chunk_r(c):
        pc = jax.lax.dynamic_slice_in_dim(prec, c * kc, kc, axis=0)
        sc = jax.lax.dynamic_slice_in_dim(scores, c * kc, kc, axis=1)
        if hist_c is not None:
            ex = sigma_mod.compact_exprs_epochs(pc, dterm, nat_u,
                                                st.nat_hist, hist_dt,
                                                hist_c)
        else:
            ex = sigma_mod.compact_exprs(pc, dterm, nat_u)
        return (0.5 * (ex.log_det_sigma + ex.quad)
                + _chunk_select(sc, ann, I))

    def pass1(carry, c):
        m, s = carry
        r = chunk_r(c)
        nm = jnp.maximum(m, jnp.max(r, axis=0))
        return (nm, s * jnp.exp(m - nm) + jnp.sum(jnp.exp(r - nm),
                                                  axis=0)), None

    (m, s), _ = jax.lax.scan(
        pass1, (jnp.full(I, -jnp.inf, dtype=dtype),
                jnp.zeros(I, dtype=dtype)), jnp.arange(C))
    log_denom = m + jnp.log(s)

    def pass2(_, c):
        w = jnp.exp(chunk_r(c) - log_denom[None, :])        # [kc, I]
        return None, jnp.einsum('ki,ia->ak', w, one_hot)[:A]

    _, sums = jax.lax.scan(pass2, None, jnp.arange(C))      # [C, A, kc]
    return jnp.moveaxis(sums, 0, 1).reshape(A, C * kc)[:, :K]


def _hist_dterms(data, st):
    """[B, P, I] per-epoch diag terms of the epoch history (lazy
    broadcast; inert slots carry scale 1)."""
    return (data.scaled_ld_diags[None, :, :]
            / st.nat_hist_scale[:, :, None])


def _epoch_exprs(data, st, nat_u, hist_c):
    dterm = _diag_term(data, st.error_scaling)
    return sigma_mod.compact_exprs_epochs(
        data.mixture_prec, dterm, nat_u, st.nat_hist,
        _hist_dterms(data, st), hist_c)


def _objective_epoch(data, st, nat_u, hist_c, hyper_delta):
    """(objective, post_means, linked) of an epoch-history parameter
    point. The trial parameters of a beta step are (nat_u, hist_c) —
    one [P, I] vector and B scalars; st supplies error_scaling and the
    epoch buffers."""
    if _use_chunked(data, nat_u):
        return _objective_chunked(data, st, nat_u, hyper_delta,
                                  hist_c=hist_c)
    with jax.named_scope('prologue'):
        ex = _epoch_exprs(data, st, nat_u, hist_c)
    return _objective_from_exprs(data, st.error_scaling, ex, hyper_delta)


def _update_beta_compact(data, st, orig_obj, cur_post_mean, cur_linked,
                         line_search_rate):
    """Compact twin of `_update_beta`: the line search mixes ONE [P, I]
    natural mean (the K-broadcast step of the reference collapses)."""
    grad = _nat_grad_resid(data, st.error_scaling, cur_post_mean,
                           cur_linked)

    def trial(L0):
        nat_new = kernels.sum_betas(st.nat_mu, grad, 1. / L0)   # [P, I]
        new_obj, pm, lk = _objective_compact(data, st, nat_new,
                                             st.hyper_delta)
        return nat_new, new_obj, pm, lk

    threshold = orig_obj - REL_TOL * jnp.abs(orig_obj) - ABS_TOL

    def cond(carry):
        L0, _, new_obj, _, _ = carry
        return jnp.logical_and(new_obj < threshold, L0 <= L_MAX)

    def body(carry):
        L0 = carry[0]
        L_next = L0 * line_search_rate
        return (L_next,) + trial(L_next)

    L0 = st.L[0]
    init = (L0,) + trial(L0)
    L0, nat_new, new_obj, pm, lk = jax.lax.while_loop(cond, body, init)

    accepted = new_obj >= threshold
    err = jnp.logical_and(
        L0 > L_MAX,
        jnp.logical_not(_isclose(orig_obj, new_obj,
                                 rtol=_err_rtol(new_obj.dtype))))
    nat_mu = jnp.where(accepted, nat_new, st.nat_mu)
    post_mean = jnp.where(accepted, pm, cur_post_mean)
    linked = jnp.where(accepted, lk, cur_linked)
    new_obj = jnp.where(accepted, new_obj, orig_obj)
    return nat_mu, L0, new_obj, post_mean, linked, err.astype(jnp.int32)


def _beta_loop_compact(data, st, conv_tol, line_search_rate):
    """Compact twin of `_beta_loop`: the while carry holds one [P, I]
    natural mean instead of [K, P, I] + [K, I] tensors."""
    obj0, pm0, lk0 = _objective_compact(data, st, st.nat_mu,
                                        st.hyper_delta)

    def body(carry):
        nat_mu, L0, num_err, orig_obj, pm, lk, delta, it, _ = carry
        L0 = jnp.maximum(1., L0 / 1.25)
        cur = dataclasses.replace(st, nat_mu=nat_mu, L=st.L.at[0].set(L0))
        nat_mu, L0, new_obj, pm, lk, err = _update_beta_compact(
            data, cur, orig_obj, pm, lk, line_search_rate)
        delta = delta + new_obj - orig_obj
        done = jnp.logical_or(
            jnp.abs(new_obj - orig_obj) <= conv_tol,
            jnp.logical_or(L0 == 1., L0 > L_MAX))
        return (nat_mu, L0, num_err + err, new_obj, pm, lk, delta,
                it + 1, done)

    def cond(carry):
        it, done = carry[7], carry[8]
        return jnp.logical_and(it < MAX_NUM_ITERS, jnp.logical_not(done))

    (nat_mu, L0, num_err, obj, pm, lk, delta, _, _) = jax.lax.while_loop(
        cond, body,
        (st.nat_mu, st.L[0], st.num_err, obj0, pm0, lk0,
         jnp.zeros_like(obj0), jnp.asarray(0), jnp.asarray(False)))
    st = dataclasses.replace(st, nat_mu=nat_mu, L=st.L.at[0].set(L0),
                             num_err=num_err)
    return st, delta, obj, pm, lk


def _update_hyper_delta_compact(data, st, orig_obj):
    """Compact twin of `_update_hyper_delta`: vi_delta is derived, the
    new nat_grad_vi_delta is implied by the new hyper_delta."""
    eps = epsilon(st.nat_mu.dtype)
    if st.nat_mu.ndim == 2 and _use_chunked(data, st.nat_mu):
        new_hd = _delta_sums_chunked(data, st, st.nat_mu,
                                     st.hyper_delta)
    else:
        _, _, vi_delta = _derive_params(data, st.error_scaling,
                                        st.nat_mu, st.hyper_delta)
        new_hd = kernels.sum_annotations(vi_delta, data.annotations,
                                         data.num_annotations)
    new_hd = jnp.maximum(
        new_hd / (data.annotation_counts[:, None] + eps), eps)
    new_hd = new_hd / new_hd.sum(axis=1, keepdims=True)
    new_obj, pm, lk = _objective_compact(data, st, st.nat_mu, new_hd)
    st = dataclasses.replace(st, hyper_delta=new_hd)
    return st, new_obj - orig_obj, new_obj, pm, lk


def _update_error_scaling_compact(data, st, orig_obj, post_means, linked):
    """Compact twin of `_update_error_scaling` for scale_se fits.

    The EM event is the one update whose natural means do NOT stay
    K-constant: the reference keeps vi_mu fixed while refreshing sigma
    and vi_delta under the new scaling (variational_inference.py:
    472-486,735-738), so the post-EM natural parameters are
    nat'_k = (prec_k + d_new) @ vi_mu_k = (prec_k + d_new) @
    sigma_old_k @ nat_k — genuinely k-dependent. The compact scale_se
    state therefore carries a [K, P, I] natural mean (sigma._nat_row);
    between EM events every update mixes it with K-constant gradients,
    and each EM event re-bases it with one closed-form sigma
    application. All derived quantities (vi_mu, vi_delta, the ELBO)
    remain exactly the reference trajectory's
    (tests/test_reference_parity.py pins this end to end)."""
    dterm_old = _diag_term(data, st.error_scaling)
    ex = sigma_mod.compact_exprs(data.mixture_prec, dterm_old, st.nat_mu)
    natvd = kernels.fast_vi_delta_grad(st.hyper_delta, data.log_det,
                                       data.annotations)
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)
    second = jnp.einsum('kpi,ki->pi', ex.diag + ex.mu ** 2, vi_delta)
    post_vars = second - post_means ** 2

    scaled_mu = post_means / data.std_errs
    quad = jnp.einsum('pi,pi->p', scaled_mu, linked)
    new_scaling = (
        data.chi_stat
        - 2 * jnp.einsum('pi,pi->p', post_means, data.adj_marginal_effects)
        + quad
        + jnp.sum(data.ld_diags * post_vars * data.std_errs ** -2, axis=1)
    ) / data.ld_ranks

    # re-base: vi_mu (= sigma_old @ nat) is unchanged by the EM;
    # express it in the NEW natural coordinates
    dterm_new = _diag_term(data, new_scaling)
    nat_new = sigma_mod.apply_precision(data.mixture_prec, dterm_new,
                                        ex.mu)
    st = dataclasses.replace(st, error_scaling=new_scaling,
                             nat_mu=nat_new)
    new_obj, pm, lk = _objective_compact(data, st, nat_new,
                                         st.hyper_delta)
    return st, new_obj - orig_obj, pm


# ---------------------------------------------------------------------------
# Epoch-history scale_se step (sigma.compact_exprs_epochs): the [K, P, I]
# kdim state is replaced by O(E) shared [P, I] epoch vectors + the
# error-scaling history. Beta steps mix (nat_u, hist_c) — the K-constant
# gradient touches only the current-epoch accumulator and the scalar
# coefficients; each EM event appends ONE epoch (the telescoping
# re-basing identity). Exact: same trajectory as the kdim path
# (tests/test_epoch_state.py).
# ---------------------------------------------------------------------------

def _update_beta_epoch(data, st, orig_obj, cur_post_mean, cur_linked,
                       line_search_rate):
    """Epoch twin of `_update_beta_compact`: nat <- (1-s)*nat + s*grad
    becomes u <- (1-s)*u + s*grad, c_e <- (1-s)*c_e."""
    grad = _nat_grad_resid(data, st.error_scaling, cur_post_mean,
                           cur_linked)

    def trial(L0):
        s = 1. / L0
        u_new = kernels.sum_betas(st.nat_mu, grad, s)        # [P, I]
        c_new = (1. - s) * st.nat_hist_c                     # [B]
        new_obj, pm, lk = _objective_epoch(data, st, u_new, c_new,
                                           st.hyper_delta)
        return u_new, c_new, new_obj, pm, lk

    threshold = orig_obj - REL_TOL * jnp.abs(orig_obj) - ABS_TOL

    def cond(carry):
        L0, _, _, new_obj, _, _ = carry
        return jnp.logical_and(new_obj < threshold, L0 <= L_MAX)

    def body(carry):
        L0 = carry[0]
        L_next = L0 * line_search_rate
        return (L_next,) + trial(L_next)

    L0 = st.L[0]
    init = (L0,) + trial(L0)
    L0, u_new, c_new, new_obj, pm, lk = jax.lax.while_loop(cond, body,
                                                           init)
    accepted = new_obj >= threshold
    err = jnp.logical_and(
        L0 > L_MAX,
        jnp.logical_not(_isclose(orig_obj, new_obj,
                                 rtol=_err_rtol(new_obj.dtype))))
    nat_u = jnp.where(accepted, u_new, st.nat_mu)
    hist_c = jnp.where(accepted, c_new, st.nat_hist_c)
    post_mean = jnp.where(accepted, pm, cur_post_mean)
    linked = jnp.where(accepted, lk, cur_linked)
    new_obj = jnp.where(accepted, new_obj, orig_obj)
    return (nat_u, hist_c, L0, new_obj, post_mean, linked,
            err.astype(jnp.int32))


def _beta_loop_epoch(data, st, conv_tol, line_search_rate):
    """Epoch twin of `_beta_loop_compact`: the while carry holds the
    [P, I] accumulator + [B] coefficients."""
    obj0, pm0, lk0 = _objective_epoch(data, st, st.nat_mu,
                                      st.nat_hist_c, st.hyper_delta)

    def body(carry):
        (nat_u, hist_c, L0, num_err, orig_obj, pm, lk, delta, it,
         _) = carry
        L0 = jnp.maximum(1., L0 / 1.25)
        cur = dataclasses.replace(st, nat_mu=nat_u, nat_hist_c=hist_c,
                                  L=st.L.at[0].set(L0))
        nat_u, hist_c, L0, new_obj, pm, lk, err = _update_beta_epoch(
            data, cur, orig_obj, pm, lk, line_search_rate)
        delta = delta + new_obj - orig_obj
        done = jnp.logical_or(
            jnp.abs(new_obj - orig_obj) <= conv_tol,
            jnp.logical_or(L0 == 1., L0 > L_MAX))
        return (nat_u, hist_c, L0, num_err + err, new_obj, pm, lk,
                delta, it + 1, done)

    def cond(carry):
        it, done = carry[8], carry[9]
        return jnp.logical_and(it < MAX_NUM_ITERS, jnp.logical_not(done))

    (nat_u, hist_c, L0, num_err, obj, pm, lk, delta, _, _) = (
        jax.lax.while_loop(
            cond, body,
            (st.nat_mu, st.nat_hist_c, st.L[0], st.num_err, obj0, pm0,
             lk0, jnp.zeros_like(obj0), jnp.asarray(0),
             jnp.asarray(False))))
    st = dataclasses.replace(st, nat_mu=nat_u, nat_hist_c=hist_c,
                             L=st.L.at[0].set(L0), num_err=num_err)
    return st, delta, obj, pm, lk


def _delta_sums_epoch(data, st, hyper_delta):
    """sum_annotations of the derived vi_delta for the epoch state."""
    if _use_chunked(data, st.nat_mu):
        return _delta_sums_chunked(data, st, st.nat_mu, hyper_delta,
                                   hist_c=st.nat_hist_c)
    ex = _epoch_exprs(data, st, st.nat_mu, st.nat_hist_c)
    natvd = kernels.fast_vi_delta_grad(hyper_delta, data.log_det,
                                       data.annotations)
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)
    return kernels.sum_annotations(vi_delta, data.annotations,
                                   data.num_annotations)


def _update_hyper_delta_epoch(data, st, orig_obj):
    """Epoch twin of `_update_hyper_delta_compact`."""
    eps = epsilon(st.nat_mu.dtype)
    new_hd = _delta_sums_epoch(data, st, st.hyper_delta)
    new_hd = jnp.maximum(
        new_hd / (data.annotation_counts[:, None] + eps), eps)
    new_hd = new_hd / new_hd.sum(axis=1, keepdims=True)
    new_obj, pm, lk = _objective_epoch(data, st, st.nat_mu,
                                       st.nat_hist_c, new_hd)
    st = dataclasses.replace(st, hyper_delta=new_hd)
    return st, new_obj - orig_obj, new_obj, pm, lk


def _update_error_scaling_epoch(data, st, orig_obj, post_means, linked):
    """Epoch twin of `_update_error_scaling_compact`.

    The EM's k-dependent re-basing becomes an epoch APPEND (the
    telescoping identity in sigma.compact_exprs_epochs): the current
    accumulator u is pushed into the history with coefficient 1 under
    the OLD scaling, and a fresh zero accumulator starts under the new
    scaling. Near-converged scalings (relative change < _EPOCH_SKIP_TOL)
    and a full buffer freeze the EM instead (no state change; the host
    grows the buffer before it fills, so freezing only happens at the
    hard cap)."""
    # post_vars of the CURRENT params (pre-EM)
    if _use_chunked(data, st.nat_mu):
        _, post_vars, _, _, _ = _chunked_moments(
            data, st, st.nat_mu, st.hyper_delta, hist_c=st.nat_hist_c)
    else:
        ex = _epoch_exprs(data, st, st.nat_mu, st.nat_hist_c)
        natvd = kernels.fast_vi_delta_grad(st.hyper_delta, data.log_det,
                                           data.annotations)
        addenda = ex.log_det_sigma + ex.quad
        li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
        vi_delta = kernels.invert_nat_cat_2D(li)
        second = jnp.einsum('kpi,ki->pi', ex.diag + ex.mu ** 2, vi_delta)
        post_vars = second - post_means ** 2

    scaled_mu = post_means / data.std_errs
    quad = jnp.einsum('pi,pi->p', scaled_mu, linked)
    new_scaling = (
        data.chi_stat
        - 2 * jnp.einsum('pi,pi->p', post_means, data.adj_marginal_effects)
        + quad
        + jnp.sum(data.ld_diags * post_vars * data.std_errs ** -2, axis=1)
    ) / data.ld_ranks

    B = st.nat_hist.shape[0]
    n = st.nat_hist_n
    changed = jnp.max(jnp.abs(new_scaling / st.error_scaling - 1.0)) \
        > _EPOCH_SKIP_TOL
    room = n < B

    def rebase(st):
        zero = jnp.zeros((), dtype=n.dtype)
        hist = jax.lax.dynamic_update_slice(
            st.nat_hist, st.nat_mu[None].astype(st.nat_hist.dtype),
            (n, zero, zero))
        scale = jax.lax.dynamic_update_slice(
            st.nat_hist_scale,
            st.error_scaling[None].astype(st.nat_hist_scale.dtype),
            (n, zero))
        c = jax.lax.dynamic_update_slice(
            st.nat_hist_c, jnp.ones(1, dtype=st.nat_hist_c.dtype), (n,))
        st = dataclasses.replace(
            st, error_scaling=new_scaling, nat_mu=jnp.zeros_like(st.nat_mu),
            nat_hist=hist, nat_hist_scale=scale, nat_hist_c=c,
            nat_hist_n=n + 1)
        new_obj, pm, _ = _objective_epoch(data, st, st.nat_mu,
                                          st.nat_hist_c, st.hyper_delta)
        return st, new_obj - orig_obj, pm

    def freeze(st):
        return st, jnp.zeros_like(orig_obj), post_means

    return jax.lax.cond(jnp.logical_and(changed, room), rebase, freeze,
                        st)


def _outer_step_epoch(data, st, line_search_rate):
    st = dataclasses.replace(st, vi_mu=None, vi_delta=None, sigma=None,
                             nat_grad_vi_delta=None)
    conv_tol = jnp.where(jnp.isnan(st.running_elbo_delta),
                         jnp.inf, 0.1 * st.running_elbo_delta)
    st, delta_beta, obj, pm, lk = _beta_loop_epoch(data, st, conv_tol,
                                                   line_search_rate)
    st, delta_hyper, obj, pm, lk = _update_hyper_delta_epoch(data, st,
                                                             obj)
    new_elbo_delta = delta_beta + delta_hyper

    def do_em(args):
        st, obj, pm, lk = args
        return _update_error_scaling_epoch(data, st, obj, pm, lk)

    def skip(args):
        st, obj, pm, lk = args
        return st, jnp.zeros_like(new_elbo_delta), pm

    st, em_delta, pm = jax.lax.cond(new_elbo_delta < EM_TOL, do_em,
                                    skip, (st, obj, pm, lk))
    new_elbo_delta = new_elbo_delta + em_delta

    red = jnp.where(jnp.isnan(st.running_elbo_delta), new_elbo_delta,
                    st.running_elbo_delta)
    red = red * ELBO_MOMENTUM + (1 - ELBO_MOMENTUM) * jnp.maximum(
        new_elbo_delta, 0)
    st = dataclasses.replace(st, elbo=st.elbo + new_elbo_delta,
                             running_elbo_delta=red)
    return st, pm * data.scalings


def _outer_step_compact(data, st, line_search_rate):
    if data.scale_se and st.nat_mu.ndim != 3:
        raise ValueError('compact scale_se fits carry a per-component '
                         '[K, P, I] natural mean (the error-scaling EM '
                         'makes natural means K-dependent); got a '
                         'shared [P, I] state')
    # drop any materialized fields (e.g. a state returned by optimize()
    # and re-stepped): they would go stale the moment nat_mu moves
    st = dataclasses.replace(st, vi_mu=None, vi_delta=None, sigma=None,
                             nat_grad_vi_delta=None)
    conv_tol = jnp.where(jnp.isnan(st.running_elbo_delta),
                         jnp.inf, 0.1 * st.running_elbo_delta)
    st, delta_beta, obj, pm, lk = _beta_loop_compact(data, st, conv_tol,
                                                     line_search_rate)
    st, delta_hyper, obj, pm, lk = _update_hyper_delta_compact(data, st,
                                                               obj)
    new_elbo_delta = delta_beta + delta_hyper

    if data.scale_se:
        def do_em(args):
            st, obj, pm, lk = args
            st, em_delta, pm = _update_error_scaling_compact(
                data, st, obj, pm, lk)
            return st, em_delta, pm

        def skip(args):
            st, obj, pm, lk = args
            return st, jnp.zeros_like(new_elbo_delta), pm

        st, em_delta, pm = jax.lax.cond(new_elbo_delta < EM_TOL, do_em,
                                        skip, (st, obj, pm, lk))
        new_elbo_delta = new_elbo_delta + em_delta

    red = jnp.where(jnp.isnan(st.running_elbo_delta), new_elbo_delta,
                    st.running_elbo_delta)
    red = red * ELBO_MOMENTUM + (1 - ELBO_MOMENTUM) * jnp.maximum(
        new_elbo_delta, 0)
    st = dataclasses.replace(st, elbo=st.elbo + new_elbo_delta,
                             running_elbo_delta=red)
    # pm is the posterior mean of the final parameters (the hyper-delta
    # objective evaluation, or the post-EM evaluation for scale_se);
    # identical to the recomputation the materialized path performs
    return st, pm * data.scalings


def _derive_params_epoch(data, error_scaling, nat_u, hist_v, hist_scale,
                         hist_c, hyper_delta):
    """(sigma, vi_mu [K,P,I], vi_delta [K,I]) derived from an
    epoch-history state (the epoch twin of `_derive_params`)."""
    dterm = _diag_term(data, error_scaling)
    hist_dterms = data.scaled_ld_diags[None] / hist_scale[:, :, None]
    ex = sigma_mod.compact_exprs_epochs(data.mixture_prec, dterm, nat_u,
                                        hist_v, hist_dterms, hist_c)
    sigma = sigma_mod.make_summaries(data.mixture_prec, data.log_det,
                                     dterm)
    natvd = kernels.fast_vi_delta_grad(hyper_delta, data.log_det,
                                       data.annotations)
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)
    return sigma, ex.mu, vi_delta


def materialize_state(data, st):
    """Fill a compact VIState's derived fields (vi_mu, vi_delta, sigma,
    nat_grad_vi_delta) — for outputs, checkpoints, and tests. Identity on
    already-materialized states."""
    if st.nat_mu is None:
        return st
    if st.nat_hist is not None:
        sigma, vi_mu, vi_delta = jax.jit(_derive_params_epoch)(
            data, st.error_scaling, st.nat_mu, st.nat_hist,
            st.nat_hist_scale, st.nat_hist_c, st.hyper_delta)
    else:
        sigma, vi_mu, vi_delta = jax.jit(_derive_params)(
            data, st.error_scaling, st.nat_mu, st.hyper_delta)
    nat_vd = _vi_delta_grad_jit(st.hyper_delta, data.log_det,
                                data.annotations)
    return dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                               sigma=sigma, nat_grad_vi_delta=nat_vd)


def compact_nat_mu(data, error_scaling, vi_mu):
    """Recover the shared [P, I] natural mean from a materialized vi_mu
    (checkpoint resume): nat = (prec_0 + diag) @ vi_mu[0]. Exact for any
    state produced by this engine or the reference (both only ever apply
    K-constant natural-gradient steps when scale_se is off)."""
    dterm = _diag_term(data, error_scaling)
    return (jnp.einsum('pq,qi->pi', data.mixture_prec[0], vi_mu[0])
            + dterm * vi_mu[0])


def compact_nat_mu_k(data, error_scaling, vi_mu):
    """Per-component [K, P, I] natural means from a materialized vi_mu
    (scale_se checkpoint resume): nat_k = (prec_k + diag) @ vi_mu[k].
    Exact — the natural parameterization is a bijection given the
    checkpointed error_scaling."""
    dterm = _diag_term(data, error_scaling)
    return sigma_mod.apply_precision(data.mixture_prec, dterm, vi_mu)


def outer_step_impl(data, st, line_search_rate=2.0):
    """One full coordinate-ascent iteration
    (reference _optimize_step/_nat_grad_step,
    variational_inference.py:396-450). Pure function — jit via
    `outer_step`, or chain multiple iterations on-device with lax
    loops (see bench.py)."""
    if st.nat_hist is not None:
        return _outer_step_epoch(data, st, line_search_rate)
    if st.nat_mu is not None:
        return _outer_step_compact(data, st, line_search_rate)
    conv_tol = jnp.where(jnp.isnan(st.running_elbo_delta),
                         jnp.inf, 0.1 * st.running_elbo_delta)
    st, delta_beta, obj, pm, lk = _beta_loop(data, st, conv_tol,
                                             line_search_rate)
    st, delta_hyper, obj, pm, lk = _update_hyper_delta(data, st, obj)
    # the annotation update is a no-op in MultiPopVI
    # (variational_inference.py:862-866)
    new_elbo_delta = delta_beta + delta_hyper

    if data.scale_se:
        def do_em(args):
            st, obj, pm, lk = args
            return _update_error_scaling(data, st, obj, pm, lk)

        def skip(args):
            return args[0], jnp.zeros_like(new_elbo_delta)

        st, em_delta = jax.lax.cond(new_elbo_delta < EM_TOL, do_em, skip,
                                    (st, obj, pm, lk))
        new_elbo_delta = new_elbo_delta + em_delta

    red = jnp.where(jnp.isnan(st.running_elbo_delta), new_elbo_delta,
                    st.running_elbo_delta)
    red = red * ELBO_MOMENTUM + (1 - ELBO_MOMENTUM) * jnp.maximum(
        new_elbo_delta, 0)
    st = dataclasses.replace(st, elbo=st.elbo + new_elbo_delta,
                             running_elbo_delta=red)
    post_mean = posterior_mean(st.vi_mu, st.vi_delta) * data.scalings
    return st, post_mean


outer_step = partial(jax.jit, static_argnames=('line_search_rate',))(
    outer_step_impl)

# Donating variant for the production optimize loop: the previous
# iteration's state buffers are dead the moment the step returns, and at
# genome scale (6M SNPs) each [K,P,I] buffer is ~0.9 GB — donating the
# state keeps peak HBM flat instead of double-buffered. Callers that
# re-read the input state after stepping must use `outer_step` instead.
outer_step_donated = partial(
    jax.jit, static_argnames=('line_search_rate',),
    donate_argnums=(1,))(outer_step_impl)


# ---------------------------------------------------------------------------
# Initialization (reference MultiPopVI._initialize,
# variational_inference.py:643-700). RNG draws happen on the host with the
# global numpy stream for golden parity; the rest runs jitted.
# ---------------------------------------------------------------------------

def make_fake_mu(data_np_inverse_betas, std_errs, ld_diags):
    """Host-side jittered initial means (variational_inference.py:646-657).
    Uses the *global* numpy RNG in the same order as the reference."""
    real_mu = np.asarray(data_np_inverse_betas)
    std_errs = np.asarray(std_errs)
    missing = np.isclose(np.asarray(ld_diags), 0)
    fake_mu = np.random.normal(loc=np.copy(real_mu), scale=1e-3 * std_errs,
                               size=real_mu.shape)
    fake_mu[missing] = np.nan
    with np.errstate(invalid='ignore'):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            mu_fill = np.tile(np.nanmean(fake_mu, axis=0),
                              [fake_mu.shape[0], 1])
    fake_mu[missing] = mu_fill[missing]
    fake_mu[np.isnan(fake_mu)] = 0.
    return fake_mu


@jax.jit
def initialize_from_fake_mu(data, sigma, error_scaling, fake_mu):
    """Device-side remainder of _initialize
    (variational_inference.py:658-700). Also returns the shared [P, I]
    natural mean (`temp_nat_mu`) that generates vi_mu — the compact
    representation's whole beta state."""
    eps = epsilon(fake_mu.dtype)
    probs = jnp.einsum('pi,oi,kpo->ki', 1.6 * fake_mu, 1.6 * fake_mu,
                       data.mixture_prec)
    probs = probs + sigma.matches - data.log_det[:, None]
    probs = jnp.exp(-0.5 * (probs - jnp.min(probs, axis=0, keepdims=True)))
    vi_delta = jnp.maximum(probs / probs.sum(axis=0, keepdims=True), eps)

    hyper = kernels.sum_annotations(vi_delta, data.annotations,
                                    data.num_annotations) + 1.
    hyper = hyper / jnp.sum(hyper, axis=1, keepdims=True)
    hyper = jnp.maximum(hyper, eps)

    nat_vi_delta = kernels.fast_vi_delta_grad(hyper, data.log_det,
                                              data.annotations)

    dterm = _diag_term(data, error_scaling)
    avg_mats = sigma_mod.sigma_weighted_sum(data.mixture_prec, dterm,
                                            vi_delta)            # [I,P,P]
    inv_avg = jnp.linalg.inv(avg_mats)
    temp_nat_mu = jnp.einsum('pi,iqp->qi', fake_mu, inv_avg)     # [P,I]
    K = data.mixture_prec.shape[0]
    vi_mu = sigma_mod.apply_sigma(
        data.mixture_prec, dterm,
        jnp.broadcast_to(temp_nat_mu[None], (K,) + temp_nat_mu.shape))

    vi_delta = kernels.fast_invert_nat_vi_delta(
        vi_mu, sigma_mod.apply_precision(data.mixture_prec, dterm, vi_mu),
        sigma.log_det_sigma, nat_vi_delta)
    return vi_mu, vi_delta, hyper, nat_vi_delta, temp_nat_mu


# ---------------------------------------------------------------------------
# Model setup (reference VIScheme.__init__ precomputation,
# variational_inference.py:96-259)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('ld_index',))
def _precompute_stats(ld, ld_index, marginal_effects, std_errs, gwas_N,
                      init_hg, real_mask):
    P = marginal_effects.shape[0]
    lds = [ld[ld_index[p]] for p in range(P)]
    ld_diags = jnp.stack([blocks_mod.diag(lds[p]) for p in range(P)])
    z_scores = marginal_effects / std_errs
    mle = jnp.stack([blocks_mod.inverse_dot(lds[p], z_scores[p])
                     for p in range(P)])
    chi_stat = jnp.einsum('pi,pi->p', z_scores, mle)
    adj = jnp.stack([blocks_mod.dot(lds[p], mle[p]) for p in range(P)])
    adj = adj / std_errs
    # layout-pad slots must not inflate the LDpred-style prior's SE^-2 sum
    # (the reference sums over all real variants incl. missing,
    # variational_inference.py:246-247)
    prior = (2 * gwas_N * init_hg) / jnp.sum(
        std_errs ** -2 * real_mask[None, :], axis=1)
    inv_z = jnp.stack([
        blocks_mod.ridge_inverse_dot(lds[p], adj[p] * std_errs[p],
                                     std_errs[p] ** 2 / prior[p])
        for p in range(P)])
    inverse_betas = inv_z * std_errs
    return ld_diags, chi_stat, adj, inverse_betas


def _floor_mixture_covs(mixture_covs, rel_floor=1e-10):
    """Floor mixture-covariance eigenvalues for sub-f64 precisions.

    The reference's covariance grid includes a near-zero spike component
    at `mins * 1e-6` (reference vi_options.py:288) where `mins` is
    data-derived — on adversarial inputs that lands below float32's
    smallest normal (a real fixture produced 6.6e-44), so the precision
    matrices cast to inf and the whole fit silently NaNs. Any variance
    that many orders of magnitude under the grid's top scale is
    statistically "exactly zero effect"; flooring eigenvalues at
    rel_floor x the largest grid variance preserves that meaning while
    keeping precisions (<= 1e10 x scale), their P<=3 determinant
    products, and their logs comfortably inside f32 range. The f64
    parity path never calls this.
    """
    w, v = np.linalg.eigh(mixture_covs)                  # [K,P], [K,P,P]
    floor = float(w.max()) * rel_floor
    if w.min() >= floor:
        return mixture_covs
    # A genuinely negative spectrum is an invalid input, not a range
    # problem: the slogdet-sign gate above (matching the reference's
    # check) passes matrices with an EVEN number of negative
    # eigenvalues, and flooring one would silently fit a different
    # model. Reject instead of repairing. (Tolerance: eigh round-off
    # on a true PSD matrix is O(f64-eps * ||A||) ~ 1e-16 * w.max,
    # orders of magnitude inside the -floor = -1e-10 * w.max gate.)
    if w.min() < -floor:
        raise ValueError('Every mixture-component covariance matrix '
                         'must be positive definite.')
    logging.info('f32 path: flooring %d mixture-covariance eigenvalues '
                 'below %.3e (near-zero spike components outside f32 '
                 'range)', int((w < floor).sum()), floor)
    w = np.maximum(w, floor)
    return np.einsum('kpq,kq,krq->kpr', v, w, v)


def build_model_data(marginal_effects, std_errs, ld_mats, annotations,
                     mixture_covs, scaled, scale_se, gwas_N, init_hg,
                     dtype=None, mesh=None):
    """Assemble ModelData with the same validations as VIScheme.__init__.

    mesh: optional device mesh for multi-process execution — host inputs
    are then placed directly as globally-sharded arrays (P x I arrays
    sharded over 'snp', small state replicated) so the precompute jit and
    everything downstream runs SPMD across hosts. ld_mats should come
    from parallel.distributed.load_ld_sharded in that case."""
    marginal_effects = np.asarray(marginal_effects)
    std_errs = np.asarray(std_errs)
    if dtype is None:
        dtype = marginal_effects.dtype
    eps = epsilon(dtype)
    if not np.all(np.isfinite(marginal_effects)):
        raise ValueError('The GWAS effect-size estimates contain a '
                         'non-finite (NaN or infinite) value.')
    if not np.all(np.isfinite(std_errs)):
        raise ValueError('The GWAS standard errors contain a '
                         'non-finite (NaN or infinite) value.')
    num_pops, num_loci = marginal_effects.shape
    if len(ld_mats) != num_pops:
        raise ValueError('One LD matrix is required per population.')
    for ld in ld_mats:
        if not isinstance(ld, blocks_mod.PackedLD):
            raise ValueError('LD Matrices must be of type PackedLD.')
        if ld.shape != (num_loci, num_loci):
            raise ValueError('An LD matrix has a different variant '
                             'count than the GWAS effect sizes.')
    annotations = np.asarray(annotations)
    row_sums = annotations.sum(axis=1)
    # all-zero rows are layout-pad sentinels (parallel/alignment.py);
    # anything else must be exactly one-hot (reference
    # variational_inference.py:197-199)
    if not np.all(np.isclose(row_sums, 1) | (row_sums == 0)):
        raise ValueError('Every SNP needs exactly one annotation; '
                         'found rows with zero or several.')
    if annotations.shape[0] != num_loci:
        raise ValueError('The annotation matrix has a different '
                         'variant count than the GWAS effect sizes.')

    mixture_covs = np.asarray(mixture_covs)
    if mixture_covs.shape[1:] != (num_pops, num_pops):
        raise ValueError('Mixture-component covariance matrices must '
                         'be [num_pops x num_pops].')
    signs, log_det = np.linalg.slogdet(mixture_covs)
    if not np.all(signs == 1):
        raise ValueError('Every mixture-component covariance matrix '
                         'must be positive definite.')
    if np.dtype(dtype) != np.float64:
        mixture_covs = _floor_mixture_covs(mixture_covs)
        log_det = np.linalg.slogdet(mixture_covs)[1]
    mixture_prec = np.linalg.inv(mixture_covs)

    if scaled:
        marginal = marginal_effects / (std_errs + eps)
        use_std_errs = np.ones_like(std_errs)
        scalings = std_errs + eps
    else:
        marginal = np.copy(marginal_effects)
        use_std_errs = np.copy(std_errs)
        scalings = np.ones_like(std_errs)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def _dev(x, spec):
            return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

        def as_pi(x):
            return _dev(np.asarray(x, dtype=dtype), P(None, 'snp'))

        def as_i(x):
            return _dev(x, P('snp'))

        def as_rep(x):
            return _dev(np.asarray(x, dtype=dtype), P())
    else:
        def as_pi(x):
            return jnp.asarray(x, dtype=dtype)

        def as_i(x):
            return jnp.asarray(x)

        def as_rep(x):
            return jnp.asarray(np.asarray(x), dtype=dtype)

    marginal = as_pi(marginal)
    use_std_errs_j = as_pi(use_std_errs)
    gwas_N = as_rep(gwas_N)
    init_hg = as_rep(init_hg)
    # deduplicate by identity: cohorts sharing one LD matrix must enter
    # jits as ONE parameter (see ModelData.ld_index)
    uniq, ld_index = [], []
    for m in ld_mats:
        matches = [j for j, u in enumerate(uniq) if u is m]
        if matches:
            ld_index.append(matches[0])
        else:
            ld_index.append(len(uniq))
            uniq.append(m)
    ld_tuple = tuple(uniq)
    ld_index = tuple(ld_index)
    real_mask = as_i((row_sums > 0).astype(dtype))
    ld_diags, chi_stat, adj, inverse_betas = _precompute_stats(
        ld_tuple, ld_index, marginal, use_std_errs_j, gwas_N, init_hg,
        real_mask)

    ld_diags_np = _fetch(ld_diags)
    if not np.allclose(_fetch(adj)[np.isclose(ld_diags_np, 0)], 0):
        raise ValueError('SNPs absent from the LD matrix have nonzero '
                         'adjusted marginal effects; they should have '
                         'been marked missing upstream.')

    num_annotations = annotations.shape[1]
    annot_idx = np.where(row_sums > 0, np.argmax(annotations, axis=1),
                         num_annotations).astype(np.int32)
    scaled_ld_diags = jax.jit(lambda s, d: s ** -2 * d)(use_std_errs_j,
                                                        ld_diags)
    return ModelData(
        marginal_effects=marginal,
        std_errs=use_std_errs_j,
        scalings=as_pi(scalings),
        ld_diags=ld_diags,
        scaled_ld_diags=scaled_ld_diags,
        adj_marginal_effects=adj,
        chi_stat=chi_stat,
        ld_ranks=as_rep([ld.get_rank() for ld in ld_mats]),
        inverse_betas=inverse_betas,
        annotations=as_i(annot_idx),
        annotation_counts=as_rep(annotations.sum(axis=0)),
        mixture_prec=as_rep(mixture_prec),
        log_det=as_rep(log_det),
        ld=ld_tuple,
        num_annotations=int(annotations.shape[1]),
        scale_se=bool(scale_se),
        ld_index=ld_index,
    )


# ---------------------------------------------------------------------------
# User-facing engine. Host-side glue never runs eager jnp ops directly on
# (possibly non-addressable multi-host) arrays — everything goes through
# these jitted helpers.
# ---------------------------------------------------------------------------

_scaled_posterior_mean = jax.jit(
    lambda vi_mu, vi_delta, scalings:
    posterior_mean(vi_mu, vi_delta) * scalings)

_scaled_posterior_variance = jax.jit(
    lambda vi_mu, vi_delta, sigma, scalings:
    kernels.fast_pmv(posterior_mean(vi_mu, vi_delta), vi_mu, vi_delta,
                     sigma.diag) * scalings ** 2)

_make_summaries_jit = jax.jit(
    lambda mixture_prec, log_det, scaled_ld_diags, error_scaling:
    sigma_mod.make_summaries(mixture_prec, log_det,
                             scaled_ld_diags / error_scaling[:, None]))

_vi_delta_grad_jit = jax.jit(kernels.fast_vi_delta_grad)


@jax.jit
def _conv_stats(new_pm, old_pm, ckp_pm, num_err, elbo, red, error_scaling):
    """Per-iteration convergence/telemetry scalars, computed on device.

    The reference fetches the full posterior-mean matrix to the host each
    iteration to run np.allclose + logging (variational_inference.py:
    374-380, 292-331). At genome scale that is a [P,I] device->host
    transfer (~16 MB at 1M SNPs) per iteration. All the optimize loop
    actually consumes are these scalars, so reduce on device and fetch
    one tiny vector (a single host round-trip per iteration)."""
    eps = epsilon(new_pm.dtype)
    diff = jnp.abs(new_pm - old_pm)
    # np.allclose(new, old, atol=ABS_TOL, rtol=REL_TOL) semantics
    allclose = jnp.all(diff <= ABS_TOL + REL_TOL * jnp.abs(old_pm))
    head = jnp.stack([
        num_err.astype(new_pm.dtype),
        jnp.asarray(elbo, dtype=new_pm.dtype),
        jnp.asarray(red, dtype=new_pm.dtype),
        allclose.astype(new_pm.dtype),
        jnp.max(jnp.abs(new_pm)),
        jnp.max(jnp.abs(diff / (old_pm + eps))),
        jnp.max(diff),
        jnp.sqrt(jnp.mean((new_pm - ckp_pm) ** 2)),
    ])
    return jnp.concatenate([head, error_scaling.astype(new_pm.dtype)])

_materialize_sigma_jit = jax.jit(
    lambda mixture_prec, scaled_ld_diags, error_scaling:
    sigma_mod.materialize_sigma(
        mixture_prec, scaled_ld_diags / error_scaling[:, None]))


@partial(jax.jit, donate_argnums=(0,))
def _nat_place_chunk_jit(nat, prec_c, scaled_ld_diags, error_scaling,
                         part, k0):
    """Recover one K-chunk of natural means and write it into the
    device-resident [K, P, I] state buffer in place (donated). Streamed
    checkpoint resume never materializes the full state on the host
    (see _nat_from_checkpoint_streamed)."""
    dterm = scaled_ld_diags / error_scaling[:, None]
    chunk = sigma_mod.apply_precision(prec_c, dterm, part)
    zero = jnp.zeros((), dtype=k0.dtype)
    return jax.lax.dynamic_update_slice(nat, chunk, (k0, zero, zero))


@jax.jit
def _vi_mu_chunk_jit(prec_c, scaled_ld_diags, error_scaling, nat_c):
    """vi_mu for a K-chunk of components: sigma_k @ nat_k, closed form.
    nat_c: [P, I] (shared; broadcast over the chunk) or [kc, P, I]."""
    dterm = scaled_ld_diags / error_scaling[:, None]
    if nat_c.ndim == 2:
        nat_c = jnp.broadcast_to(nat_c[None],
                                 (prec_c.shape[0],) + nat_c.shape)
    return sigma_mod.apply_sigma(prec_c, dterm, nat_c)


@jax.jit
def _derived_cols_jit(mixture_prec, log_det, hyper_delta, error_scaling,
                      nat_mu, scaled_ld_diags, annotations, idx):
    """(vi_delta [C, K], post_mean [P, C], post_var [P, C]) of the
    compact state at SNP columns `idx` — the bounded-memory building
    block for genome-scale output streaming (a production mixture grid's
    materialized vi_mu/vi_delta are tens of GB; see MultiPopVI.dump_spec).
    Same closed forms as `_objective_compact`'s staging."""
    nat_c = nat_mu[..., idx]
    dt_c = scaled_ld_diags[:, idx] / error_scaling[:, None]
    ann_c = annotations[idx]
    natvd = kernels.fast_vi_delta_grad(hyper_delta, log_det, ann_c)
    ex = sigma_mod.compact_exprs(mixture_prec, dt_c, nat_c)
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)                 # [K, C]
    pm = jnp.einsum('kpc,kc->pc', ex.mu, vi_delta)
    second = jnp.einsum('kpc,kc->pc', ex.diag + ex.mu ** 2, vi_delta)
    return vi_delta.T, pm, second - pm ** 2

@jax.jit
def _derived_cols_epoch_jit(mixture_prec, log_det, hyper_delta,
                            error_scaling, nat_u, hist_v, hist_scale,
                            hist_c, scaled_ld_diags, annotations, idx):
    """Epoch twin of `_derived_cols_jit` (bounded-memory output
    streaming for epoch-history states)."""
    u_c = nat_u[:, idx]
    hv_c = hist_v[..., idx]
    sld_c = scaled_ld_diags[:, idx]
    dt_c = sld_c / error_scaling[:, None]
    hist_dt = sld_c[None] / hist_scale[:, :, None]
    ann_c = annotations[idx]
    natvd = kernels.fast_vi_delta_grad(hyper_delta, log_det, ann_c)
    ex = sigma_mod.compact_exprs_epochs(mixture_prec, dt_c, u_c, hv_c,
                                        hist_dt, hist_c)
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)                 # [K, C]
    pm = jnp.einsum('kpc,kc->pc', ex.mu, vi_delta)
    second = jnp.einsum('kpc,kc->pc', ex.diag + ex.mu ** 2, vi_delta)
    return vi_delta.T, pm, second - pm ** 2


@jax.jit
def _vi_mu_chunk_epoch_jit(prec_c, scaled_ld_diags, error_scaling,
                           nat_u, hist_v, hist_scale, hist_c):
    """vi_mu for a K-chunk of an epoch-history state (XLA drops the
    unused CompactExprs outputs)."""
    dterm = scaled_ld_diags / error_scaling[:, None]
    hist_dt = scaled_ld_diags[None] / hist_scale[:, :, None]
    ex = sigma_mod.compact_exprs_epochs(prec_c, dterm, nat_u, hist_v,
                                        hist_dt, hist_c)
    return ex.mu


# outputs whose derived [K, *, I] members exceed this stream to disk in
# chunks instead of materializing (MultiPopVI.dump_spec / _stream_big)
_STREAM_OUTPUT_BYTES = 1 << 28

# host-side chunk budget for streamed checkpoint recovery
# (_nat_from_checkpoint_streamed); tests shrink it to prove boundedness
_RESUME_CHUNK_BYTES = 256 << 20


def _write_npz_all_ranks(path, arrays, streams):
    """Write an .npz whose streamed members are computed chunk-by-chunk.

    Multi-host: every rank must consume the stream generators (each
    chunk's fetch all-gathers across processes), but only rank 0 writes
    the file."""
    if jax.process_index() == 0:
        from vilma_tpu.utils.npz_stream import save_npz_stream
        save_npz_stream(path, arrays, streams)
    else:
        for _, _, _, chunk_iter in streams:
            for _ in chunk_iter:
                pass


class MultiPopVI:
    """Drop-in equivalent of the reference MultiPopVI
    (variational_inference.py:567-889): same constructor surface, same
    optimize()/checkpoint semantics, same output arrays."""

    param_names = ['vi_mu', 'vi_delta', 'hyper_delta']

    def __init__(self, marginal_effects=None, std_errs=None, ld_mats=None,
                 annotations=None, mixture_covs=None, checkpoint=True,
                 checkpoint_freq=5, scaled=False, scale_se=False,
                 output='vilma_output', gwas_N=None, init_hg=None,
                 num_its=None, dtype=None, mesh=None, out_index=None):
        """out_index: optional int array mapping original variant order to
        positions in the (aligned-layout) inputs; outputs/checkpoints are
        produced in original order (see parallel/alignment.py)."""
        for name, val in [('marginal_effects', marginal_effects),
                          ('std_errs', std_errs), ('ld_mats', ld_mats),
                          ('annotations', annotations),
                          ('mixture_covs', mixture_covs),
                          ('gwas_N', gwas_N), ('init_hg', init_hg),
                          ('num_its', num_its)]:
            if val is None:
                raise ValueError(f'{name} must be specified when calling '
                                 'MultiPopVI()')
        self._multiproc = jax.process_count() > 1
        if self._multiproc and mesh is None:
            raise ValueError('multi-process fits need a device mesh '
                             '(--mesh snp=<total devices>)')
        if self._multiproc and (np.asarray(marginal_effects).shape[1]
                                % mesh.shape['snp']):
            raise ValueError('multi-process fits need the variant count '
                             'to be divisible by the snp mesh axis; pad '
                             'the extract list or adjust the mesh')
        self.mesh = mesh
        # shard-local LD (blocks.PackedLD.shard_count > 1) runs its
        # matvecs as shard_map over the ambient mesh — which must
        # therefore be set for every jit that touches the LD, including
        # the precompute inside build_model_data
        with self._mesh_ctx():
            self.data = build_model_data(
                marginal_effects, std_errs, ld_mats, annotations,
                mixture_covs, scaled, scale_se, gwas_N, init_hg,
                dtype=dtype, mesh=mesh if self._multiproc else None)
        if out_index is None:
            out_index = np.arange(self.data.marginal_effects.shape[1])
        self._out_index = np.asarray(out_index)
        self._orig_loci = int(self._out_index.shape[0])
        if self._multiproc:
            pass        # build_model_data already placed everything
        elif mesh is not None:
            from vilma_tpu.parallel import mesh as mesh_mod
            from vilma_tpu.parallel import padding
            self.data, _ = padding.pad_model_data(
                self.data, mesh.shape['snp'])
            self.data = mesh_mod.shard_data(self.data, mesh)
        else:
            # --mmap spills arrive as disk-backed numpy bucket leaves;
            # promote them to device arrays once so every jitted step does
            # not re-stream them host->device
            self.data = jax.tree.map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray)
                else x, self.data)
        self.scaled = scaled
        self.scale_se = scale_se
        self.checkpoint = checkpoint
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_path = '%s-checkpoint' % output
        self.num_its = num_its
        self.num_pops = self.data.marginal_effects.shape[0]
        self.num_loci = self._orig_loci
        self._padded_loci = self.data.marginal_effects.shape[1]
        assert self._out_index.max(initial=-1) < self._padded_loci
        self.num_mix = self.data.mixture_prec.shape[0]
        self.num_annotations = self.data.num_annotations
        # the compact state applies whenever the closed-form sigma
        # algebra covers P (models/sigma.py): non-scale_se fits carry a
        # shared [P, I] natural mean; scale_se fits carry a
        # per-component [K, P, I] one (each error-scaling EM event makes
        # natural means K-dependent — _update_error_scaling_compact).
        # Either way no [K, I]-shaped state arrays or sigma summaries
        # live in HBM between evaluations.
        self._compact = self.num_pops <= 3
        # scale_se fits whose kdim state would be too large (the
        # production mixture grid x genome scale: 582 x 2 x 6M f32 is
        # ~26 GiB) switch to the EPOCH-HISTORY representation
        # (sigma.compact_exprs_epochs): O(E) shared [P, I] vectors +
        # the scaling history, exact and bounded.
        itemsize = np.dtype(self.data.marginal_effects.dtype).itemsize
        kdim_bytes = (self.num_mix * self.num_pops * self._padded_loci
                      * itemsize)
        self._epoch = bool(self._compact and self.scale_se
                           and kdim_bytes > _EPOCH_STATE_BYTES)
        self._hist_cap_warned = False
        if self._epoch:
            logging.info(
                'scale_se state uses the epoch-history representation '
                '(the per-component [K, P, I] state would be %.1f GiB)',
                kdim_bytes / 2 ** 30)
        self.state = None

    def _mesh_ctx(self):
        """jax.set_mesh(self.mesh) when a mesh is configured (shard_map
        matvecs need the ambient mesh), nullcontext otherwise."""
        from contextlib import nullcontext
        return (jax.set_mesh(self.mesh) if self.mesh is not None
                else nullcontext())

    # -- pieces reused by fit/sim/tests ------------------------------------
    @property
    def error_scaling(self):
        return _fetch(self.state.error_scaling)

    @property
    def scalings(self):
        return _fetch(self.data.scalings)

    @property
    def vi_sigma(self):
        """Materialized [K,P,P,I] variational covariances (output parity
        with reference vi_options.py:264 only — never used in compute)."""
        return _fetch(_materialize_sigma_jit(
            self.data.mixture_prec, self.data.scaled_ld_diags,
            self.state.error_scaling))[..., self._out_index]

    def vi_sigma_chunks(self, chunk_k=None):
        """Yield vi_sigma in [<=chunk_k, P, P, I] component chunks.

        The full materialized array (reference vi_options.py:264) is
        [K, P, P, I] — with a production mixture grid (~582 components
        for 2 cohorts at -K 12) that is ~19 GB at 1M SNPs and ~112 GB at
        6M, so a converged genome-scale fit would die materializing its
        own output. Chunking along K bounds host memory at one chunk
        (~256 MB default); utils/npz_stream.save_npz_stream writes the
        chunks straight into the output .npz. In multi-host runs every
        rank must iterate the SAME chunk sequence (the fetch
        all-gathers); only rank 0 writes."""
        K = self.num_mix
        P = self.num_pops
        dtype = np.dtype(self.data.marginal_effects.dtype)
        if chunk_k is None:
            per_k = max(self._orig_loci * P * P * dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        # slice the precision table on the host: eager slicing of a
        # replicated multi-host array is not allowed
        prec = _fetch(self.data.mixture_prec)
        for k0 in range(0, K, chunk_k):
            part = _materialize_sigma_jit(
                prec[k0:k0 + chunk_k], self.data.scaled_ld_diags,
                self.state.error_scaling)
            yield _fetch(part)[..., self._out_index]

    # -- genome-scale output streaming (see dump_spec) ---------------------
    def _stream_big(self):
        """Whether derived [K, *, I] outputs exceed the in-memory budget
        (production mixture grids at genome scale: 582 components x 6M
        SNPs is ~28 GB of vi_mu alone)."""
        itemsize = np.dtype(self.data.marginal_effects.dtype).itemsize
        return (self._compact
                and self.num_mix * self.num_pops * self._padded_loci
                * itemsize > _STREAM_OUTPUT_BYTES)

    def vi_mu_chunks(self, st=None, chunk_k=None):
        """Yield vi_mu in [<=chunk_k, P, I] component chunks derived
        from the compact state (vi_mu_k = sigma_k @ nat_k; epoch states
        sum their history — sigma.compact_exprs_epochs)."""
        st = st or self.state
        assert st.nat_mu is not None
        K, P = self.num_mix, self.num_pops
        dtype = np.dtype(self.data.marginal_effects.dtype)
        if chunk_k is None:
            per_k = max(self._padded_loci * P * dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        prec = _fetch(self.data.mixture_prec)
        for k0 in range(0, K, chunk_k):
            if st.nat_hist is not None:
                part = _vi_mu_chunk_epoch_jit(
                    prec[k0:k0 + chunk_k], self.data.scaled_ld_diags,
                    st.error_scaling, st.nat_mu, st.nat_hist,
                    st.nat_hist_scale, st.nat_hist_c)
            else:
                nat = (st.nat_mu if st.nat_mu.ndim == 2
                       else st.nat_mu[k0:k0 + chunk_k])
                part = _vi_mu_chunk_jit(prec[k0:k0 + chunk_k],
                                        self.data.scaled_ld_diags,
                                        st.error_scaling, nat)
            yield _fetch(part)[..., self._out_index]

    def _derived_col_chunks(self, st, chunk_i=None):
        """Yield (vi_delta [c, K], pm [P, c], pv [P, c]) over chunks of
        the ORIGINAL variant order (bounded device memory; the chunk
        gathers run under the mesh in multi-host fits)."""
        st = st or self.state
        assert st.nat_mu is not None
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        if chunk_i is None:
            chunk_i = max(1024, (64 << 20) // max(K * P * 4, 1))
        chunk_i = min(chunk_i, n)
        ix = self._out_index
        for i0 in range(0, n, chunk_i):
            idx = ix[i0:i0 + chunk_i]
            real = idx.shape[0]
            if real < chunk_i:
                # fixed gather length keeps ONE compiled program; the
                # padded tail columns are discarded below
                idx = np.concatenate(
                    [idx, np.full(chunk_i - real, idx[-1],
                                  dtype=idx.dtype)])
            if st.nat_hist is not None:
                vd, pm, pv = _derived_cols_epoch_jit(
                    self.data.mixture_prec, self.data.log_det,
                    st.hyper_delta, st.error_scaling, st.nat_mu,
                    st.nat_hist, st.nat_hist_scale, st.nat_hist_c,
                    self.data.scaled_ld_diags, self.data.annotations,
                    jnp.asarray(idx))
            else:
                vd, pm, pv = _derived_cols_jit(
                    self.data.mixture_prec, self.data.log_det,
                    st.hyper_delta, st.error_scaling, st.nat_mu,
                    self.data.scaled_ld_diags, self.data.annotations,
                    jnp.asarray(idx))
            yield (_fetch(vd)[:real], _fetch(pm)[:, :real],
                   _fetch(pv)[:, :real])

    def vi_delta_chunks(self, st=None, chunk_i=None):
        """Yield the [I, K] (reference-layout) vi_delta in row chunks."""
        for vd, _, _ in self._derived_col_chunks(st, chunk_i):
            yield vd

    def dump_spec(self, st=None):
        """(arrays, streams) covering the reference checkpoint/.npz key
        set (vi_mu, vi_delta, hyper_delta, error_scaling, scalings —
        reference variational_inference.py:333-338).

        Small problems return everything materialized in `arrays`
        (exactly create_dump_dict); genome-scale compact fits whose
        derived [K, *, I] members exceed the budget stream vi_mu
        (component chunks) and vi_delta (variant chunks) instead, for
        utils/npz_stream.save_npz_stream."""
        st = st or self.state
        if st.nat_mu is None or not self._stream_big():
            return self.create_dump_dict(st), []
        ix = self._out_index
        arrays = {
            'hyper_delta': _fetch(st.hyper_delta),
            'error_scaling': _fetch(st.error_scaling),
            'scalings': _fetch(self.data.scalings)[:, ix],
        }
        arrays.update(self._epoch_dump_arrays(st))
        dtype = np.dtype(self.data.marginal_effects.dtype)
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        streams = [
            ('vi_mu', (K, P, n), dtype, self.vi_mu_chunks(st)),
            ('vi_delta', (n, K), dtype, self.vi_delta_chunks(st)),
        ]
        return arrays, streams

    def _fresh_state(self, error_scaling=None):
        dtype = self.data.marginal_effects.dtype
        # host leaves stay numpy until they enter a jit (multi-host: numpy
        # args are valid replicated pjit inputs; local jax.Arrays are not)
        if error_scaling is None:
            error_scaling = np.ones(self.num_pops, dtype=dtype)
        else:
            error_scaling = np.asarray(error_scaling, dtype=dtype)
        K = self.num_mix
        zeros = lambda *s: np.zeros(s, dtype=dtype)  # noqa: E731
        if self._compact:
            P, L = self.num_pops, self._padded_loci
            if self._epoch:
                B0 = _EPOCH_BUCKETS[0]
                return VIState(
                    vi_mu=None, vi_delta=None, nat_grad_vi_delta=None,
                    sigma=None,
                    nat_mu=zeros(P, L),
                    nat_hist=zeros(B0, P, L),
                    nat_hist_scale=np.ones((B0, P), dtype=dtype),
                    nat_hist_c=zeros(B0),
                    nat_hist_n=np.asarray(0, dtype=np.int32),
                    hyper_delta=zeros(self.num_annotations, K),
                    error_scaling=error_scaling,
                    L=np.ones(3, dtype=dtype),
                    elbo=np.asarray(0., dtype=dtype),
                    running_elbo_delta=np.asarray(np.nan, dtype=dtype),
                    num_err=np.asarray(0, dtype=np.int32),
                )
            nat_shape = ((P, L) if not self.scale_se else (K, P, L))
            return VIState(
                vi_mu=None, vi_delta=None, nat_grad_vi_delta=None,
                sigma=None,
                nat_mu=zeros(*nat_shape),
                hyper_delta=zeros(self.num_annotations, K),
                error_scaling=error_scaling,
                L=np.ones(3, dtype=dtype),
                elbo=np.asarray(0., dtype=dtype),
                running_elbo_delta=np.asarray(np.nan, dtype=dtype),
                num_err=np.asarray(0, dtype=np.int32),
            )
        sig = _make_summaries_jit(self.data.mixture_prec,
                                  self.data.log_det,
                                  self.data.scaled_ld_diags,
                                  error_scaling)
        return VIState(
            vi_mu=zeros(K, self.num_pops, self._padded_loci),
            vi_delta=zeros(K, self._padded_loci),
            hyper_delta=zeros(self.num_annotations, K),
            error_scaling=error_scaling,
            nat_grad_vi_delta=zeros(K - 1, self._padded_loci),
            sigma=sig,
            L=np.ones(3, dtype=dtype),
            elbo=np.asarray(0., dtype=dtype),
            running_elbo_delta=np.asarray(np.nan, dtype=dtype),
            num_err=np.asarray(0, dtype=np.int32),
        )

    def _initialize(self):
        st = self._fresh_state()
        ix = self._out_index
        # draw the init jitter over the original variant order so seeded
        # runs consume the same RNG stream as the reference regardless of
        # layout padding; pad slots keep vi_mu exactly 0
        fake = make_fake_mu(
            _fetch(self.data.inverse_betas)[:, ix],
            _fetch(self.data.std_errs)[:, ix],
            _fetch(self.data.ld_diags)[:, ix])
        fake_mu = np.zeros((self.num_pops, self._padded_loci),
                           dtype=self.data.marginal_effects.dtype)
        fake_mu[:, ix] = fake
        logging.info('Max |inverse_beta| at initialization: %f',
                     float(np.max(np.abs(_fetch(
                         self.data.inverse_betas)))))
        sig = st.sigma
        if sig is None:     # compact: summaries only needed transiently
            sig = _make_summaries_jit(self.data.mixture_prec,
                                      self.data.log_det,
                                      self.data.scaled_ld_diags,
                                      st.error_scaling)
        vi_mu, vi_delta, hyper, nat_vd, temp_nat = initialize_from_fake_mu(
            self.data, sig, st.error_scaling, fake_mu)
        if self._compact:
            if self.scale_se and not self._epoch:
                # initialization is K-constant (error_scaling all ones);
                # the per-component state starts as a plain broadcast
                # (epoch states instead start with temp_nat as the
                # current-epoch accumulator and an empty history)
                temp_nat = jnp.broadcast_to(
                    temp_nat[None], (self.num_mix,) + temp_nat.shape)
            return dataclasses.replace(st, nat_mu=temp_nat,
                                       hyper_delta=hyper)
        return dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                                   hyper_delta=hyper,
                                   nat_grad_vi_delta=nat_vd)

    def _state_from_checkpoint(self, loaded_checkpoint):
        dtype = self.data.marginal_effects.dtype
        error_scaling = None
        if 'error_scaling' in getattr(loaded_checkpoint, 'files',
                                      loaded_checkpoint):
            error_scaling = loaded_checkpoint['error_scaling']
        else:
            logging.warning('The checkpoint carries no "error_scaling" '
                            'entry; defaulting all error scalings to 1.')
        st = self._fresh_state(error_scaling)
        hyper = np.asarray(loaded_checkpoint['hyper_delta'], dtype=dtype)
        ix = self._out_index
        if self._epoch:
            files = getattr(loaded_checkpoint, 'files',
                            loaded_checkpoint)
            if 'nat_u' not in files:
                raise ValueError(
                    'this fit uses the epoch-history scale_se state '
                    '(the per-component [K, P, I] state would not fit '
                    'in device memory), but the checkpoint lacks the '
                    'epoch keys (nat_u/nat_hist/...). Resume from a '
                    'checkpoint written by this engine, or shrink the '
                    'problem below the epoch threshold.')
            P, L = self.num_pops, self._padded_loci
            u = np.zeros((P, L), dtype=dtype)
            u[:, ix] = np.asarray(loaded_checkpoint['nat_u'],
                                  dtype=dtype)
            hist_in = np.asarray(loaded_checkpoint['nat_hist'],
                                 dtype=dtype)
            B = hist_in.shape[0]
            hist = np.zeros((B, P, L), dtype=dtype)
            hist[..., ix] = hist_in
            return dataclasses.replace(
                st, nat_mu=u, nat_hist=hist,
                nat_hist_scale=np.asarray(
                    loaded_checkpoint['nat_hist_scale'], dtype=dtype),
                nat_hist_c=np.asarray(loaded_checkpoint['nat_hist_c'],
                                      dtype=dtype),
                nat_hist_n=np.asarray(loaded_checkpoint['nat_hist_n'],
                                      dtype=np.int32),
                hyper_delta=hyper)
        if self._compact and self._stream_big():
            # genome-scale compact resume: the checkpoint's vi_mu member
            # is tens of GB — recover the natural mean(s) in bounded
            # chunks straight off the uncompressed zip member
            nat = self._nat_from_checkpoint_streamed(loaded_checkpoint,
                                                     st, dtype)
            return dataclasses.replace(st, nat_mu=nat, hyper_delta=hyper)
        vi_mu_in = np.asarray(loaded_checkpoint['vi_mu'], dtype=dtype)
        K = vi_mu_in.shape[0]
        vi_mu = np.zeros((K, self.num_pops, self._padded_loci),
                         dtype=dtype)
        vi_mu[..., ix] = vi_mu_in
        if self._compact:
            # recover the natural mean(s) from the stored vi_mu (exact
            # for any checkpoint this engine or the reference writes;
            # see compact_nat_mu / compact_nat_mu_k)
            recover = compact_nat_mu_k if self.scale_se else compact_nat_mu
            nat = jax.jit(recover)(self.data, st.error_scaling,
                                   jnp.asarray(vi_mu))
            return dataclasses.replace(st, nat_mu=nat, hyper_delta=hyper)
        nat_vd = _vi_delta_grad_jit(hyper, self.data.log_det,
                                    self.data.annotations)
        vi_delta_in = np.asarray(loaded_checkpoint['vi_delta'],
                                 dtype=dtype)
        # uniform pad rows keep log(vi_delta) finite; pads are masked out
        # of every reduction and rewritten by the first update
        vi_delta = np.full((K, self._padded_loci), 1.0 / K, dtype=dtype)
        vi_delta[:, ix] = vi_delta_in.T
        return dataclasses.replace(
            st,
            vi_mu=vi_mu,
            vi_delta=vi_delta,
            hyper_delta=hyper,
            nat_grad_vi_delta=nat_vd)

    def _nat_from_checkpoint_streamed(self, loaded_checkpoint, st, dtype):
        """Bounded-memory natural-mean recovery from a genome-scale
        checkpoint (see _state_from_checkpoint). Non-scale_se states
        need only vi_mu[0] (compact_nat_mu); scale_se states process the
        member in K-chunks (compact_nat_mu_k chunk by chunk)."""
        from vilma_tpu.utils.npz_stream import npz_member_memmap
        mm = npz_member_memmap(loaded_checkpoint, 'vi_mu')
        if mm is None:
            logging.warning('checkpoint vi_mu member is not mappable '
                            '(compressed?); falling back to a '
                            'materialized read')
            mm = loaded_checkpoint['vi_mu']
        ix = self._out_index
        P = self.num_pops
        if not self.scale_se:
            vi0 = np.zeros((1, P, self._padded_loci), dtype=dtype)
            vi0[..., ix] = np.asarray(mm[0], dtype=dtype)
            return jax.jit(compact_nat_mu)(self.data, st.error_scaling,
                                           jnp.asarray(vi0))
        K = self.num_mix
        itemsize = np.dtype(dtype).itemsize
        chunk = max(1, _RESUME_CHUNK_BYTES
                    // max(P * self._padded_loci * itemsize, 1))
        prec = _fetch(self.data.mixture_prec)
        # recover straight into the device-resident state buffer: the
        # host only ever holds one [chunk, P, I] slab, and the donated
        # dynamic_update_slice keeps a single device copy (a host-side
        # np.empty((K, P, I)) here would be the same tens-of-GB
        # materialization the streaming machinery exists to avoid)
        nat = jnp.zeros((K, P, self._padded_loci), dtype=dtype)
        for k0 in range(0, K, chunk):
            kc = min(chunk, K - k0)
            part = np.zeros((kc, P, self._padded_loci), dtype=dtype)
            part[..., ix] = np.asarray(mm[k0:k0 + kc], dtype=dtype)
            nat = _nat_place_chunk_jit(
                nat, prec[k0:k0 + kc], self.data.scaled_ld_diags,
                st.error_scaling, jnp.asarray(part),
                jnp.asarray(k0, dtype=jnp.int32))
        return nat

    def elbo_value(self, st=None):
        st = st or self.state
        with self._mesh_ctx():
            if (st.nat_hist is not None and st.vi_mu is None
                    and self._stream_big()):
                return float(elbo_epoch_jit(
                    self.data, st.error_scaling, st.nat_mu, st.nat_hist,
                    st.nat_hist_scale, st.nat_hist_c, st.hyper_delta))
            if (st.nat_mu is not None and st.vi_mu is None
                    and self._stream_big()):
                return float(elbo_compact_jit(
                    self.data, st.error_scaling, st.nat_mu,
                    st.hyper_delta))
            st = materialize_state(self.data, st)
            return float(elbo_jit(self.data, st.sigma, st.error_scaling,
                                  st.vi_mu, st.vi_delta, st.hyper_delta))

    def create_dump_dict(self, st=None):
        st = st or self.state
        if (st.nat_mu is not None and st.vi_mu is None
                and self._stream_big()):
            raise MemoryError(
                'materializing the derived vi_mu/vi_delta of this '
                'problem needs tens of GB; use dump_spec() + '
                'utils/npz_stream.save_npz_stream (fit does this '
                'automatically)')
        with self._mesh_ctx():
            mat = materialize_state(self.data, st)
        ix = self._out_index
        out = {
            'vi_mu': _fetch(mat.vi_mu)[:, :, ix],
            'vi_delta': _fetch(mat.vi_delta)[:, ix].T,
            'hyper_delta': _fetch(mat.hyper_delta),
            'error_scaling': _fetch(mat.error_scaling),
            'scalings': _fetch(self.data.scalings)[:, ix],
        }
        out.update(self._epoch_dump_arrays(st))
        return out

    def _epoch_dump_arrays(self, st):
        """Extra checkpoint keys for epoch-history states: the compact
        state itself, so genome-scale resume restores it directly
        instead of recovering a [K, P, I] tensor it cannot hold."""
        if st.nat_hist is None:
            return {}
        ix = self._out_index
        return {
            'nat_u': _fetch(st.nat_mu)[:, ix],
            'nat_hist': _fetch(st.nat_hist)[..., ix],
            'nat_hist_scale': _fetch(st.nat_hist_scale),
            'nat_hist_c': _fetch(st.nat_hist_c),
            'nat_hist_n': np.asarray(_fetch(st.nat_hist_n)),
        }

    def _streamed_moments(self, st):
        """(posterior mean, variance) in original order, assembled from
        bounded chunks (genome-scale compact fits; [P, n] is small even
        when [K, *, I] is not)."""
        P, n = self.num_pops, self.num_loci
        dtype = np.dtype(self.data.marginal_effects.dtype)
        pm = np.empty((P, n), dtype=dtype)
        pv = np.empty((P, n), dtype=dtype)
        pos = 0
        for _, pm_c, pv_c in self._derived_col_chunks(st):
            c = pm_c.shape[1]
            pm[:, pos:pos + c] = pm_c
            pv[:, pos:pos + c] = pv_c
            pos += c
        scalings = _fetch(self.data.scalings)[:, self._out_index]
        return pm * scalings, pv * scalings ** 2

    def real_posterior_mean(self, st=None):
        st = st or self.state
        with self._mesh_ctx():
            if (st.nat_mu is not None and st.vi_mu is None
                    and self._stream_big()):
                return self._streamed_moments(st)[0]
            st = materialize_state(self.data, st)
            return _fetch(_scaled_posterior_mean(
                st.vi_mu, st.vi_delta,
                self.data.scalings))[:, self._out_index]

    def real_posterior_variance(self, st=None):
        st = st or self.state
        with self._mesh_ctx():
            if (st.nat_mu is not None and st.vi_mu is None
                    and self._stream_big()):
                return self._streamed_moments(st)[1]
            st = materialize_state(self.data, st)
            return _fetch(_scaled_posterior_variance(
                st.vi_mu, st.vi_delta, st.sigma,
                self.data.scalings))[:, self._out_index]

    def optimize(self, loaded_checkpoint=None):
        """Coordinate ascent until convergence
        (reference optimize(), variational_inference.py:340-394)."""
        with self._mesh_ctx():
            return self._optimize_impl(loaded_checkpoint)

    def _optimize_impl(self, loaded_checkpoint=None):
        if loaded_checkpoint is None:
            st = self._initialize()
        else:
            st = self._state_from_checkpoint(loaded_checkpoint)
        if self.mesh is not None:
            from vilma_tpu.parallel import mesh as mesh_mod
            st = mesh_mod.shard_state(st, self.mesh)
        if st.nat_hist is not None:
            def _pm(s):
                return _scaled_posterior_mean_epoch(
                    self.data, s.error_scaling, s.nat_mu, s.nat_hist,
                    s.nat_hist_scale, s.nat_hist_c, s.hyper_delta)
            e0 = elbo_epoch_jit(self.data, st.error_scaling, st.nat_mu,
                                st.nat_hist, st.nat_hist_scale,
                                st.nat_hist_c, st.hyper_delta)
        elif st.nat_mu is not None:
            def _pm(s):
                return _scaled_posterior_mean_compact(
                    self.data, s.error_scaling, s.nat_mu, s.hyper_delta)
            e0 = elbo_compact_jit(self.data, st.error_scaling, st.nat_mu,
                                  st.hyper_delta)
        else:
            def _pm(s):
                return _scaled_posterior_mean(s.vi_mu, s.vi_delta,
                                              self.data.scalings)
            e0 = elbo_jit(self.data, st.sigma, st.error_scaling,
                          st.vi_mu, st.vi_delta, st.hyper_delta)
        st = dataclasses.replace(st, elbo=e0)
        converged = False
        num_its = 0
        # the posterior-mean history stays on device; only the reduced
        # convergence/telemetry scalars cross to the host each iteration
        post_mean = _pm(st)
        ckp_post_mean = post_mean
        prev_err = 0
        while num_its < self.num_its and not converged:
            if num_its % self.checkpoint_freq == 0 and self.checkpoint:
                fname = '{}.{}'.format(self.checkpoint_path, num_its)
                arrays, streams = self.dump_spec(st)
                _write_npz_all_ranks(fname, arrays, streams)
                ckp_post_mean = _pm(st)
            st, new_post_mean = outer_step_donated(self.data, st,
                                                   line_search_rate=2.0)
            if self._epoch:
                # keep a free epoch slot ahead of the next EM event so
                # the in-step append never freezes before the hard cap
                # (bucketed growth: a handful of recompiles per fit)
                st = self._maybe_grow_hist(st)
            stats = _fetch(_conv_stats(new_post_mean, post_mean,
                                       ckp_post_mean, st.num_err, st.elbo,
                                       st.running_elbo_delta,
                                       st.error_scaling))
            num_err = int(stats[0])
            if num_err > prev_err:
                raise RuntimeError('Encountered a numerical error.')
            prev_err = num_err
            # secondary guard for the reduced-precision paths: the
            # line-search consistency check runs with a loosened rtol on
            # f32/bf16 (_err_rtol), so a fit that silently degenerates
            # to NaN would otherwise "converge" and write NaN outputs
            if np.isnan(stats[1]) or np.isnan(stats[4]):
                raise RuntimeError('Encountered a numerical error '
                                   '(non-finite ELBO or posterior mean).')
            red = float(stats[2])

            converged = bool(stats[3])
            converged = converged or np.isclose(red, 0, atol=ELBO_TOL,
                                                rtol=0)
            if num_its < 10 and loaded_checkpoint is None:
                converged = False

            self._dump_info(num_its, stats)
            post_mean = new_post_mean
            num_its += 1

        if num_its == self.num_its:
            logging.warning('Failed to converge')
        logging.info('Optimization ran for %d iterations', num_its)
        if self._stream_big() and st.nat_mu is not None:
            # materializing [K, *, I] derived arrays at production-grid
            # genome scale is tens of GB — keep the compact state;
            # outputs go through the chunked/streamed paths
            # (dump_spec, _streamed_moments, vi_sigma_chunks)
            self.state = st
            return self.state
        # expose a materialized state (vi_mu/vi_delta/sigma filled) so
        # downstream consumers and tests see the full parameter set; the
        # compact nat_mu is kept alongside, so re-stepping this state
        # stays on the compact path
        self.state = materialize_state(self.data, st)
        return self.state

    def _maybe_grow_hist(self, st):
        """Grow the epoch buffer to the next bucket once nearly full
        (host-side; shape change => one recompile per bucket)."""
        B = st.nat_hist.shape[0]
        n = int(_fetch(st.nat_hist_n))
        if n < B - 1:
            return st
        if B >= _EPOCH_CAP:
            if n >= B and not self._hist_cap_warned:
                logging.warning(
                    'error-scaling epoch history reached its cap (%d); '
                    'further EM updates are frozen (the scaling has '
                    'seen %d re-basings and is effectively converged)',
                    _EPOCH_CAP, n)
                self._hist_cap_warned = True
            return st
        nb = next(b for b in _EPOCH_BUCKETS if b > B)
        pad = nb - B
        with self._mesh_ctx():
            h, s, c = jax.jit(lambda h, s, c: (
                jnp.pad(h, ((0, pad), (0, 0), (0, 0))),
                jnp.pad(s, ((0, pad), (0, 0)), constant_values=1.0),
                jnp.pad(c, (0, pad))))(st.nat_hist, st.nat_hist_scale,
                                       st.nat_hist_c)
        logging.info('epoch history grown %d -> %d slots', B, nb)
        return dataclasses.replace(st, nat_hist=h, nat_hist_scale=s,
                                   nat_hist_c=c)

    def _dump_info(self, num_its, stats):
        """Per-iteration telemetry (reference _dump_info,
        variational_inference.py:292-331) from the on-device-reduced
        stats vector of _conv_stats."""
        logging.info('Completed iteration %d', num_its + 1)
        logging.info('ELBO = %f, running delta = %f', float(stats[1]),
                     float(stats[2]))
        logging.info('Maximum posterior mean beta: %e', float(stats[4]))
        logging.info('SE scaling is: %r', np.asarray(stats[8:]))
        logging.info('Max relative difference is: %e', float(stats[5]))
        logging.info('Max absolute difference is: %e', float(stats[6]))
        logging.info('RMSE difference (checkpoint iterations) is: %e',
                     float(stats[7]))
