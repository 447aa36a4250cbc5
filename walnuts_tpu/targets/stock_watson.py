"""Stock-Watson stochastic-volatility model as a native JAX target.

Re-implements the reference's only real-data model,
``WALNUTSpy_examples/StockWatson/sw_innov.stan:1-52`` (non-centered
random-walk state space fit via BridgeStan in ``mainSW.py:15-26``), as
a pure-JAX log density.  This removes the reference's only FFI
boundary — BridgeStan crossed Python->C once per gradient evaluation
(``mainSW.py:20``) — and replaces the three sequential Stan
``for`` recursions (``sw_innov.stan:28-36``) with ``cumsum`` prefix
sums, which XLA lowers to a parallel prefix scan.

Unconstrained parameter layout (Stan declaration order):
``[tSigma, z1, zinn[T-2], x1, xinn[T-1], tau1, tauinn[T-1]]`` —
``D = 3T`` total.

Model::

    sigma    = exp(-tSigma/2)
    z[1..T-1]: z_1 = z1,  z_t   = z_{t-1}  + sigma * zinn_{t-1}
    x[1..T]  : x_1 = x1,  x_t   = x_{t-1}  + sigma * xinn_{t-1}
    tau[1..T]: tau_1=tau1, tau_t = tau_{t-1} + exp(z_{t-1}/2) * tauinn_{t-1}
    target  += 5*tSigma - exp(tSigma)/2
             + sum N(zinn|0,1) + sum N(xinn|0,1) + sum N(tauinn|0,1)
             + sum N(y_t | tau_t, exp(x_t/2))

**The reference model as shipped has an IMPROPER posterior.**
``sw_innov.stan:40-42`` comments out the initial-state priors
(``//z1 ~ normal(0.0, 1.0); // to be removed`` etc.), leaving ``z1``
with no prior at all.  As ``z1 -> -inf`` every ``exp(z_t/2) -> 0``,
``tau`` freezes at ``tau1``, and the likelihood tends to the constant
``prod_t N(y_t | tau1, exp(x_t/2)) > 0`` — the density is exactly
flat in that direction (verified numerically: ``logp`` is bitwise
identical at ``z1 = -130`` and ``z1 = -1030``), so ``int dz1``
diverges.  Multi-chain runs therefore drift apart forever on the
``z`` block (measured: cross-chain z sd ~ 113 and growing after 4000
transitions) and NO sampler can pass a split-Rhat gate on it; the
reference's own single 11k-draw chain merely wandered slowly from its
(unshipped) ``initq.npy`` start.  ``stock_watson(proper=True)``
restores exactly the three commented-out N(0,1) priors, which makes
the posterior proper; the gated convergence artifact
(``examples/stock_watson.py``) runs that variant and keeps a
reference-parity arm on the improper model for the identified
quantities.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np

from .base import Target

_LOG_2PI = math.log(2.0 * math.pi)
_DATA_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "examples", "data", "swdata.json"
)


def load_sw_data(path=None):
    with open(path or _DATA_PATH) as f:
        d = json.load(f)
    return int(d["T"]), np.asarray(d["y"], dtype=np.float64)


def _split(q, T):
    i = 0
    t_sigma = q[..., 0]
    z1 = q[..., 1]
    zinn = q[..., 2 : T]                       # T-2
    x1 = q[..., T]
    xinn = q[..., T + 1 : 2 * T]               # T-1
    tau1 = q[..., 2 * T]
    tauinn = q[..., 2 * T + 1 : 3 * T]         # T-1
    return t_sigma, z1, zinn, x1, xinn, tau1, tauinn


def _states(q, T):
    t_sigma, z1, zinn, x1, xinn, tau1, tauinn = _split(q, T)
    sigma = jnp.exp(-0.5 * t_sigma)
    z = z1[..., None] + jnp.concatenate(
        [jnp.zeros_like(z1)[..., None], sigma[..., None] * jnp.cumsum(zinn, axis=-1)],
        axis=-1,
    )  # [..., T-1]
    x = x1[..., None] + jnp.concatenate(
        [jnp.zeros_like(x1)[..., None], sigma[..., None] * jnp.cumsum(xinn, axis=-1)],
        axis=-1,
    )  # [..., T]
    tau = tau1[..., None] + jnp.concatenate(
        [jnp.zeros_like(tau1)[..., None],
         jnp.cumsum(jnp.exp(0.5 * z) * tauinn, axis=-1)],
        axis=-1,
    )  # [..., T]
    return t_sigma, z, x, tau, (zinn, xinn, tauinn)


def stock_watson(data_path=None, proper=False) -> Target:
    """``proper=False`` is the reference model verbatim (improper
    posterior, see module docstring); ``proper=True`` restores the
    z1/x1/tau1 ~ N(0,1) priors of ``sw_innov.stan:40-42``."""
    T, y_np = load_sw_data(data_path)
    y = jnp.asarray(y_np)
    dim = 3 * T

    def logp_batched(q):
        t_sigma, z, x, tau, (zinn, xinn, tauinn) = _states(q, T)
        lp = 5.0 * t_sigma - 0.5 * jnp.exp(t_sigma)
        if proper:
            z1, x1, tau1 = q[..., 1], q[..., T], q[..., 2 * T]
            lp = lp - 0.5 * (z1 * z1 + x1 * x1 + tau1 * tau1
                             + 3.0 * _LOG_2PI)
        n_inn = (T - 2) + 2 * (T - 1)
        lp = lp - 0.5 * (
            jnp.sum(zinn * zinn, axis=-1)
            + jnp.sum(xinn * xinn, axis=-1)
            + jnp.sum(tauinn * tauinn, axis=-1)
        ) - 0.5 * n_inn * _LOG_2PI
        # y_t ~ N(tau_t, exp(x_t / 2))
        resid = y - tau
        lp = lp - 0.5 * jnp.sum(resid * resid * jnp.exp(-x) + x, axis=-1)
        lp = lp - 0.5 * T * _LOG_2PI
        return lp

    def logp(q):
        return logp_batched(q[None, :])[0]

    def generated(q):
        """Constrained quantities for the plotsSW quantile bands:
        ``concat([sigma, z, x, tau])`` (cf. ``mainSW.py:28`` using
        ``param_constrain(..., include_tp=True)``)."""
        t_sigma, z, x, tau, _ = _states(q, T)
        sigma = jnp.exp(-0.5 * t_sigma)
        return jnp.concatenate([sigma[..., None], z, x, tau], axis=-1)

    suffix = "_proper" if proper else ""
    return Target(logp, dim, name=f"stock_watson_T{T}{suffix}",
                  generated=generated)
