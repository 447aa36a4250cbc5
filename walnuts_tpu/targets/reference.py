"""Plain NumPy float64 references, written independently of the JAX
targets and integrators, for checking them on a device and for the
single-core baseline in ``bench.py``."""

import math

import numpy as np

_LOG_2PI = math.log(2.0 * math.pi)


def funnel_logp_grad(q, scale=3.0):
    """Neal's funnel: normalised log density and its gradient at
    ``q`` of shape ``[..., D]``, where ``q[..., 0] = omega ~
    N(0, scale^2)`` and ``q[..., 1:] | omega ~ N(0, e^omega)``."""
    q = np.asarray(q, np.float64)
    w = q[..., 0]
    x = q[..., 1:]
    k = x.shape[-1]
    e = np.exp(-w)
    ss = np.sum(x * x, axis=-1)
    lp = (-0.5 * (w / scale) ** 2 - math.log(scale) - 0.5 * _LOG_2PI
          - 0.5 * e * ss - 0.5 * k * w - 0.5 * k * _LOG_2PI)
    g = np.empty_like(q)
    g[..., 0] = -w / scale ** 2 + 0.5 * e * ss - 0.5 * k
    g[..., 1:] = -x * e[..., None]
    return lp, g


def leapfrog(logp_grad, q, v, g, h, n=1):
    """``n`` velocity-Verlet steps of size ``h`` (a scalar, or one
    per chain shaped to broadcast against ``q``).  Returns
    ``(q, v, g, lp)`` at the end point."""
    lp = None
    for _ in range(n):
        vh = v + 0.5 * h * g
        q = q + h * vh
        lp, g = logp_grad(q)
        v = vh + 0.5 * h * g
    return q, v, g, lp
