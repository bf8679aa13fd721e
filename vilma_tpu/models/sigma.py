"""Closed-form algebra for the variational covariances vi_sigma.

In the reference, the per-SNP/per-component variational covariance

    vi_sigma[k,:,:,i] = inv( mixture_prec[k] + diag(scaled_ld_diags[:,i]
                                                    / error_scaling) )

is materialized as a [K,P,P,I] array (reference
variational_inference.py:712-733) — tens of GB at genome scale. It is,
however, a deterministic function of K PxP precision matrices and a [P,I]
diagonal, so we never materialize it: every contraction against
vi_sigma is expressed with closed-form PxP inverses (P = #populations is
1-3 in practice) fused into the consuming kernel, keeping HBM traffic at
O(K*P*I) instead of O(K*P^2*I). For P >= 4 a chunked batched-solve path
(lax.map over I-chunks) keeps temporaries bounded, so any population
count runs at genome scale. SURVEY.md section 7.3 item 5.

Functions take `diag_term` = scaled_ld_diags / error_scaling[:, None]
([P, I]) and `mixture_prec` ([K, P, P]).
"""
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class SigmaSummaries:
    """Precomputed O(K*I) summaries of vi_sigma, refreshed whenever
    error_scaling changes (reference _set_vi_sigma,
    variational_inference.py:712-733)."""
    log_det_sigma: jnp.ndarray    # [K, I]  log det vi_sigma
    sigma_summary: jnp.ndarray    # [K, I]  logdet prior - logdet sigma + trace match
    diag: jnp.ndarray             # [K, P, I] diagonal of vi_sigma
    matches: jnp.ndarray          # [K, I]  trace(mixture_prec[k] @ sigma[k,i])
    #   all [K, I] (K-major: the reference keeps these [I, K]; see
    #   kernels.fast_posterior_mean)


jax.tree_util.register_dataclass(
    SigmaSummaries,
    data_fields=('log_det_sigma', 'sigma_summary', 'diag', 'matches'),
    meta_fields=(),
)


def _precision_parts(mixture_prec, diag_term):
    """Split the per-(k,i) precision into reusable [K,I] component arrays."""
    K, P, _ = mixture_prec.shape
    if P == 1:
        a = mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :]   # [K,I]
        return (a,)
    if P == 2:
        a = mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :]
        b = mixture_prec[:, 0, 1][:, None] + jnp.zeros_like(diag_term[0])
        d = mixture_prec[:, 1, 1][:, None] + diag_term[1][None, :]
        return (a, b, d)
    if P == 3:
        # M[k,i] = [[a, b, c], [b, d, e], [c, e, f]]; diag entries vary
        # with i, off-diagonals stay [K, 1] broadcastables (the diag_term
        # is diagonal, so it never touches them)
        a = mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :]
        d = mixture_prec[:, 1, 1][:, None] + diag_term[1][None, :]
        f = mixture_prec[:, 2, 2][:, None] + diag_term[2][None, :]
        b = mixture_prec[:, 0, 1][:, None]
        c = mixture_prec[:, 0, 2][:, None]
        e = mixture_prec[:, 1, 2][:, None]
        return (a, b, c, d, e, f)
    raise NotImplementedError


def _adjugate3(parts):
    """Adjugate entries + determinant of the symmetric 3x3 family.

    inverse[k,i] = adj / det with adj = [[A, B, C], [B, D, E], [C, E, F]];
    all six entries are [K, I] (the diagonal entries vary with i)."""
    a, b, c, d, e, f = parts
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    return A, B, C, D, E, F, det


def _use_closed_form(P):
    return P <= 3


# Chunk length for the generic P>=4 path: bounds its [K, C, P, P]
# batched-solve temporaries to a few MB regardless of genome size
# (the reference materializes the full [K, P, P, I] vi_sigma for every
# P, variational_inference.py:712-733 — at 1M SNPs that is tens of GB).
_GENERIC_CHUNK = 4096


def _map_i_chunks(fn, diag_term, extra=None, extra_pad=0.0):
    """Run `fn(diag_chunk [P,C], extra_chunk)` over I-chunks via lax.map.

    `diag_term` is [P, I]; `extra` (optional) has I as its LAST axis.
    `fn` returns a pytree of arrays whose last axis is the chunk; chunks
    are concatenated back to I. The diag pad value is 1.0 so padded
    precision slots stay invertible (mixture_prec[k] + I is PD); padded
    outputs are sliced off before returning.
    """
    P, I = diag_term.shape
    C = min(_GENERIC_CHUNK, I)
    n = -(-I // C)
    pad = n * C - I
    dt = jnp.pad(diag_term, ((0, 0), (0, pad)), constant_values=1.0)
    dt = jnp.moveaxis(dt.reshape(P, n, C), 1, 0)            # [n, P, C]
    if extra is not None:
        widths = [(0, 0)] * (extra.ndim - 1) + [(0, pad)]
        ex = jnp.pad(extra, widths, constant_values=extra_pad)
        ex = jnp.moveaxis(ex.reshape(*extra.shape[:-1], n, C), -2, 0)
        out = jax.lax.map(lambda args: fn(*args), (dt, ex))
    else:
        out = jax.lax.map(fn, dt)

    def unchunk(o):
        o = jnp.moveaxis(o, 0, -2)                          # [..., n, C]
        return o.reshape(*o.shape[:-2], n * C)[..., :I]

    return jax.tree_util.tree_map(unchunk, out)


def apply_precision(mixture_prec, diag_term, x):
    """(mixture_prec[k] + diag(diag_term[:,i])) @ x[k,:,i] -> [K,P,I].

    This is the reference's fast_nat_inner_product_m2(vi_mu, nat_sigma)
    with nat_sigma = -precision/2 (numerics.py:68-80): the -2 and -1/2
    cancel, so old natural means are just precision @ vi_mu.
    """
    return (jnp.einsum('kpq,kqi->kpi', mixture_prec, x)
            + diag_term[None, :, :] * x)


def apply_sigma(mixture_prec, diag_term, x):
    """vi_sigma[k,:,:,i] @ x[k,:,i] -> [K,P,I] via closed-form solves."""
    P = mixture_prec.shape[1]
    if _use_closed_form(P):
        parts = _precision_parts(mixture_prec, diag_term)
        if P == 1:
            (a,) = parts
            return (x[:, 0, :] / a)[:, None, :]
        if P == 2:
            a, b, d = parts
            det = a * d - b * b
            x0, x1 = x[:, 0, :], x[:, 1, :]
            y0 = (d * x0 - b * x1) / det
            y1 = (a * x1 - b * x0) / det
            return jnp.stack([y0, y1], axis=1)
        A, B, C, D, E, F, det = _adjugate3(parts)
        x0, x1, x2 = x[:, 0, :], x[:, 1, :], x[:, 2, :]
        y0 = (A * x0 + B * x1 + C * x2) / det
        y1 = (B * x0 + D * x1 + E * x2) / det
        y2 = (C * x0 + E * x1 + F * x2) / det
        return jnp.stack([y0, y1, y2], axis=1)
    # generic fallback (P >= 4): batched PxP solve over I-chunks so the
    # [K, C, P, P] temporaries stay bounded at genome scale
    def _chunk(dt_c, x_c):
        prec = _dense_precision(mixture_prec, dt_c)        # [K,C,P,P]
        rhs = jnp.transpose(x_c, (0, 2, 1))[..., None]     # [K,C,P,1]
        sol = jnp.linalg.solve(prec, rhs)[..., 0]          # [K,C,P]
        return jnp.transpose(sol, (0, 2, 1))               # [K,P,C]

    return _map_i_chunks(_chunk, diag_term, x)


def _dense_precision(mixture_prec, diag_term):
    K, P, _ = mixture_prec.shape
    eye = jnp.eye(P, dtype=mixture_prec.dtype)
    return (mixture_prec[:, None, :, :]
            + eye * jnp.transpose(diag_term, (1, 0))[None, :, :, None])


def make_summaries(mixture_prec, log_det_prior, diag_term):
    """Build the O(K*I) vi_sigma summaries.

    log_det_prior: [K] log-determinants of the prior mixture covariances
    (note: of the covariances, i.e. -logdet(mixture_prec), matching
    reference MultiPopVI.log_det, variational_inference.py:624-626).
    """
    P = mixture_prec.shape[1]
    if _use_closed_form(P):
        parts = _precision_parts(mixture_prec, diag_term)
        if P == 1:
            (a,) = parts
            log_det_sigma = -jnp.log(a)                       # [K,I]
            diag = (1.0 / a)[:, None, :]                      # [K,1,I]
            matches = mixture_prec[:, 0, 0][:, None] / a      # [K,I]
        elif P == 2:
            a, b, d = parts
            det = a * d - b * b
            log_det_sigma = -jnp.log(det)
            diag = jnp.stack([d / det, a / det], axis=1)      # [K,2,I]
            p00 = mixture_prec[:, 0, 0][:, None]
            p01 = mixture_prec[:, 0, 1][:, None]
            p11 = mixture_prec[:, 1, 1][:, None]
            matches = (p00 * d - 2 * p01 * b + p11 * a) / det  # [K,I]
        else:
            A, B, C, D, E, F, det = _adjugate3(parts)
            log_det_sigma = -jnp.log(det)
            diag = jnp.stack([A, D, F], axis=1) / det[:, None, :]
            pr = mixture_prec[:, :, :, None]                  # [K,3,3,1]
            # trace(prec @ sigma) over the symmetric entries
            matches = (pr[:, 0, 0] * A + pr[:, 1, 1] * D + pr[:, 2, 2] * F
                       + 2 * (pr[:, 0, 1] * B + pr[:, 0, 2] * C
                              + pr[:, 1, 2] * E)) / det       # [K,I]
    else:
        def _chunk(dt_c):
            prec = _dense_precision(mixture_prec, dt_c)       # [K,C,P,P]
            sigma = jnp.linalg.inv(prec)
            lds = -jnp.linalg.slogdet(prec)[1]                # [K,C]
            dg = jnp.transpose(jnp.diagonal(sigma, axis1=-2, axis2=-1),
                               (0, 2, 1))                     # [K,P,C]
            mt = jnp.einsum('kpq,kcqp->kc', mixture_prec, sigma)
            return lds, dg, mt

        log_det_sigma, diag, matches = _map_i_chunks(_chunk, diag_term)
    sigma_summary = (log_det_prior[:, None] - log_det_sigma + matches)
    return SigmaSummaries(log_det_sigma=log_det_sigma,
                          sigma_summary=sigma_summary,
                          diag=diag,
                          matches=matches)


@dataclass(frozen=True)
class CompactExprs:
    """Per-component closed forms of the compact [P, I] natural-mean
    state (engine.VIState docstring) — returned as lazily-traced
    expressions so XLA fuses the K axis into the consuming reductions.

    mu[k] = vi_sigma[k] @ nat_mu; quad[k] = mu[k].nat_mu;
    quadform[k] = mu[k]' mixture_prec[k] mu[k]; the rest are the
    SigmaSummaries fields."""
    mu: jnp.ndarray               # [K, P, I]
    diag: jnp.ndarray             # [K, P, I]
    log_det_sigma: jnp.ndarray    # [K, I]
    matches: jnp.ndarray          # [K, I]
    quad: jnp.ndarray             # [K, I]
    quadform: jnp.ndarray         # [K, I]


def _nat_row(nat_mu, p):
    """Population-p rows of a natural mean, broadcastable over [K, I].

    nat_mu may be the shared [P, I] compact state (natural means constant
    in K — every non-scale_se fit) or the per-component [K, P, I] state
    (scale_se fits: each error-scaling EM event re-bases the natural
    means k-dependently, see engine._update_error_scaling_compact)."""
    if nat_mu.ndim == 2:
        return nat_mu[p][None, :]                           # [1, I]
    return nat_mu[:, p, :]                                  # [K, I]


def compact_exprs(mixture_prec, diag_term, nat_mu):
    """Build CompactExprs from the closed-form P<=3 algebra.

    nat_mu: [P, I] (K-shared) or [K, P, I] (per-component) natural
    means — see `_nat_row`."""
    P = mixture_prec.shape[1]
    if not _use_closed_form(P):
        raise NotImplementedError('compact expressions need the closed-'
                                  'form sigma algebra (P <= 3)')
    parts = _precision_parts(mixture_prec, diag_term)
    if P == 1:
        (a,) = parts
        n0 = _nat_row(nat_mu, 0)                            # [1|K, I]
        mu0 = n0 / a                                        # [K, I]
        p00 = mixture_prec[:, 0, 0][:, None]
        return CompactExprs(
            mu=mu0[:, None, :], diag=(1.0 / a)[:, None, :],
            log_det_sigma=-jnp.log(a), matches=p00 / a,
            quad=n0 * mu0, quadform=p00 * mu0 * mu0)
    if P == 2:
        a, b, d = parts
        det = a * d - b * b
        n0, n1 = _nat_row(nat_mu, 0), _nat_row(nat_mu, 1)
        y0 = (d * n0 - b * n1) / det
        y1 = (a * n1 - b * n0) / det
        p00 = mixture_prec[:, 0, 0][:, None]
        p01 = mixture_prec[:, 0, 1][:, None]
        p11 = mixture_prec[:, 1, 1][:, None]
        return CompactExprs(
            mu=jnp.stack([y0, y1], axis=1),
            diag=jnp.stack([d / det, a / det], axis=1),
            log_det_sigma=-jnp.log(det),
            matches=(p00 * d - 2 * p01 * b + p11 * a) / det,
            quad=y0 * n0 + y1 * n1,
            quadform=p00 * y0 * y0 + 2 * p01 * y0 * y1 + p11 * y1 * y1)
    A, B, C, D, E, F, det = _adjugate3(parts)
    n0, n1, n2 = (_nat_row(nat_mu, 0), _nat_row(nat_mu, 1),
                  _nat_row(nat_mu, 2))
    y0 = (A * n0 + B * n1 + C * n2) / det
    y1 = (B * n0 + D * n1 + E * n2) / det
    y2 = (C * n0 + E * n1 + F * n2) / det
    pr = mixture_prec[:, :, :, None]
    matches = (pr[:, 0, 0] * A + pr[:, 1, 1] * D + pr[:, 2, 2] * F
               + 2 * (pr[:, 0, 1] * B + pr[:, 0, 2] * C
                      + pr[:, 1, 2] * E)) / det
    quadform = (pr[:, 0, 0] * y0 * y0 + pr[:, 1, 1] * y1 * y1
                + pr[:, 2, 2] * y2 * y2
                + 2 * (pr[:, 0, 1] * y0 * y1 + pr[:, 0, 2] * y0 * y2
                       + pr[:, 1, 2] * y1 * y2))
    return CompactExprs(
        mu=jnp.stack([y0, y1, y2], axis=1),
        diag=jnp.stack([A, D, F], axis=1) / det[:, None, :],
        log_det_sigma=-jnp.log(det), matches=matches,
        quad=y0 * n0 + y1 * n1 + y2 * n2, quadform=quadform)


def compact_exprs_epochs(mixture_prec, diag_term, nat_u, hist_v,
                         hist_dterms, hist_c):
    """CompactExprs of the EPOCH-HISTORY scale_se state.

    A scale_se fit's natural means become K-dependent only through the
    error-scaling EM re-basings (engine._update_error_scaling_compact),
    and those maps TELESCOPE: (prec_k + d^E)(prec_k + d^{E-1})^{-1} ...
    (prec_k + d^{e+1})(prec_k + d^e)^{-1} = (prec_k + d^E)(prec_k +
    d^e)^{-1}. After E EM events the whole [K, P, I] state is therefore

        vi_mu_k = sum_e hist_c[e] * sigma_k^{(e)} @ hist_v[e]
                  + sigma_k^{(cur)} @ nat_u,

    i.e. E+1 SHARED [P, I] vectors + the scaling history + E scalar
    coefficients — O(E*P*I) memory instead of O(K*P*I) (26 GiB at 6M
    SNPs with the 582-component production grid). Exact: the derived
    vi_mu/vi_delta/ELBO equal the kdim representation's bit-for-float
    (tests/test_epoch_state.py pins trajectory equality).

    Args:
        nat_u: [P, I] current-epoch accumulator.
        hist_v: [B, P, I] historical shared vectors (slots >= the live
            count carry hist_c == 0 and are inert).
        hist_dterms: [B, P, I] scaled_ld_diags / hist_scale per epoch.
        hist_c: [B] coefficients.
    """
    K = mixture_prec.shape[0]

    def bk(x):
        return jnp.broadcast_to(x[None], (K,) + x.shape)

    mu = apply_sigma(mixture_prec, diag_term, bk(nat_u))
    for e in range(hist_v.shape[0]):
        mu = mu + hist_c[e] * apply_sigma(mixture_prec, hist_dterms[e],
                                          bk(hist_v[e]))
    nat = apply_precision(mixture_prec, diag_term, mu)
    s = make_summaries(mixture_prec, jnp.zeros(K, dtype=mu.dtype),
                       diag_term)
    quad = jnp.einsum('kpi,kpi->ki', mu, nat)
    quadform = jnp.einsum('kpq,kpi,kqi->ki', mixture_prec, mu, mu)
    return CompactExprs(mu=mu, diag=s.diag,
                        log_det_sigma=s.log_det_sigma,
                        matches=s.matches, quad=quad, quadform=quadform)


def sigma_weighted_sum(mixture_prec, diag_term, vi_delta):
    """sum_k vi_delta[k,i] * vi_sigma[k,:,:,i] -> [I,P,P].

    Used only at initialization (reference variational_inference.py:681-684).
    vi_delta: [K, I] (K-major).
    """
    P = mixture_prec.shape[1]
    if _use_closed_form(P):
        parts = _precision_parts(mixture_prec, diag_term)
        if P == 1:
            (a,) = parts
            out = jnp.einsum('ki,ki->i', vi_delta, 1.0 / a)
            return out[:, None, None]
        if P == 2:
            a, b, d = parts
            det = a * d - b * b
            s00 = jnp.einsum('ki,ki->i', vi_delta, d / det)
            s01 = jnp.einsum('ki,ki->i', vi_delta, -b / det)
            s11 = jnp.einsum('ki,ki->i', vi_delta, a / det)
            row0 = jnp.stack([s00, s01], axis=-1)
            row1 = jnp.stack([s01, s11], axis=-1)
            return jnp.stack([row0, row1], axis=-2)           # [I,2,2]
        A, B, C, D, E, F, det = _adjugate3(parts)
        w = lambda adj: jnp.einsum('ki,ki->i', vi_delta, adj / det)  # noqa
        s00, s01, s02 = w(A), w(B), w(C)
        s11, s12, s22 = w(D), w(E), w(F)
        row0 = jnp.stack([s00, s01, s02], axis=-1)
        row1 = jnp.stack([s01, s11, s12], axis=-1)
        row2 = jnp.stack([s02, s12, s22], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2)         # [I,3,3]
    def _chunk(dt_c, vd_c):
        prec = _dense_precision(mixture_prec, dt_c)           # [K,C,P,P]
        sigma = jnp.linalg.inv(prec)
        return jnp.einsum('kc,kcpq->pqc', vd_c, sigma)        # [P,P,C]

    out = _map_i_chunks(_chunk, diag_term, vi_delta)          # [P,P,I]
    return jnp.transpose(out, (2, 0, 1))


def materialize_sigma(mixture_prec, diag_term):
    """Dense [K,P,P,I] vi_sigma — only for checkpoint/output parity with the
    reference's saved `vi_sigma` array (vi_options.py:264) and for tests."""
    prec = _dense_precision(mixture_prec, diag_term)          # [K,I,P,P]
    sigma = jnp.linalg.inv(prec)
    return jnp.transpose(sigma, (0, 2, 3, 1))
