"""Gradient-based ELBO optimization (validation mode).

The coordinate-ascent engine (inference.engine) is the production path; this
module maximizes the *same* ELBO with optax over unconstrained
parameterizations, as an independent check that the natural-gradient
updates converge to a true ELBO optimum.

Parameterization:
    vi_mu           unconstrained [K, P, I]
    vi_delta        logits [K, I] -> softmax over K
    hyper_delta     logits [A, K] -> softmax rows

The variational covariances stay at their closed-form optimum given
error_scaling (as in the reference, variational_inference.py:712-733), so
the ELBO here is the same function the coordinate-ascent engine evaluates.
"""
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from vilma_tpu.inference import engine


@dataclass(frozen=True)
class GradParams:
    vi_mu: jnp.ndarray
    delta_logits: jnp.ndarray
    hyper_logits: jnp.ndarray


jax.tree_util.register_dataclass(
    GradParams, data_fields=('vi_mu', 'delta_logits', 'hyper_logits'),
    meta_fields=())


def _constrain(params):
    vi_delta = jax.nn.softmax(params.delta_logits, axis=0)
    hyper_delta = jax.nn.softmax(params.hyper_logits, axis=1)
    return params.vi_mu, vi_delta, hyper_delta


def elbo_of(data, sigma, error_scaling, params):
    vi_mu, vi_delta, hyper_delta = _constrain(params)
    return engine.elbo(data, sigma, error_scaling, vi_mu, vi_delta,
                       hyper_delta)


def fit_elbo_gradient(data, state, num_steps=500, learning_rate=1e-2):
    """Maximize the ELBO with Adam starting from a VIState.

    Returns (final VIState-compatible params tuple, elbo trace).
    """
    import optax  # optional dependency (extras_require['validation'])
    state = engine.materialize_state(data, state)  # compact states
    sigma = state.sigma
    error_scaling = state.error_scaling
    eps = jnp.finfo(state.vi_delta.dtype).tiny
    params = GradParams(
        vi_mu=state.vi_mu,
        delta_logits=jnp.log(jnp.maximum(state.vi_delta, eps)),
        hyper_logits=jnp.log(jnp.maximum(state.hyper_delta, eps)),
    )
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: -elbo_of(data, sigma, error_scaling, p))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, -loss

    trace = []
    for _ in range(num_steps):
        params, opt_state, cur = step(params, opt_state)
        trace.append(float(cur))
    vi_mu, vi_delta, hyper_delta = _constrain(params)
    return (vi_mu, vi_delta, hyper_delta), trace
