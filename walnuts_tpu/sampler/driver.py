"""Chain driver and warmup adaptation (layers L3/L4).

Replicates the reference's iteration loop and tuning rules
(``WALNUTSpy/WALNUTS.py:189-717``):

* per-iteration full momentum refresh + one WALNUTS transition;
* warmup adaptation of the integrator tolerance ``delta``: record
  ``orbitEnergyError / delta`` each warmup iteration and, after
  iteration 10, set ``delta = target / quantile_q(history)``
  (``WALNUTS.py:701-707``);
* warmup adaptation of the macro step ``H``: every computed macro step
  pushes ``log(igrConst)`` into a P2 estimator of the
  ``1 - adaptHtarget`` quantile and ``H = delta^{1/3} * exp(quantile)``
  (``WALNUTS.py:139-141,711-712``).

Everything is batched: each chain runs its own adaptation state, so a
C-chain run is statistically identical to C independent reference
runs.  The whole loop is one ``lax.scan`` under jit; samples and the
24-column diagnostics stream out as scan outputs.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.p2 import P2State, p2_init, p2_quantile
from .transition import WalnutsConfig, walnuts_transition


class WarmupConfig(NamedTuple):
    """Static warmup configuration (defaults of ``WALNUTS.py:115-127``).

    ``pooled=True`` enables the cross-chain consensus mode the
    reference never had (it adapts one chain at a time): the
    delta-quantile and the P2 step-size statistic are averaged over
    the whole chain batch each iteration, so every chain shares one
    ``(H, delta)``.  On a chain-sharded mesh the pooling reductions
    lower to XLA collectives between devices (SURVEY §5 'distributed
    communication backend').  Pooled mode converges in far fewer
    warmup iterations (C chains give C samples of the adaptation
    statistics per iteration) and keeps the batch's work profile
    homogeneous — important for a batch that pays the max orbit depth
    over chains.
    """

    warmup_iter: int = 1000
    adapt_h: bool = True
    adapt_h_target: float = 0.8
    adapt_delta: bool = True
    adapt_delta_target: float = 0.6
    adapt_delta_quantile: float = 0.9
    pooled: bool = False


class SamplerState(NamedTuple):
    q: jnp.ndarray        # [C, D]
    lp: jnp.ndarray       # [C]
    g: jnp.ndarray        # [C, D]
    h: jnp.ndarray        # [C] macro step size
    delta: jnp.ndarray    # [C] tolerance
    p2: P2State           # per-chain log-igrConst quantile estimator
    err_facs: jnp.ndarray  # [C, warmup_iter] energy-error inflation history
    iter_n: jnp.ndarray   # scalar int32, completed iterations


def masked_quantile(x, n, prob):
    """``np.quantile(x[:, :n], prob)`` per row, for traced ``n``.

    Unfilled columns are pushed to +inf before an ascending sort, then
    the standard linear-interpolation quantile is read at position
    ``(n - 1) * prob``.
    """
    C, W = x.shape
    cols = jnp.arange(W)
    xs = jnp.sort(jnp.where(cols[None, :] < n, x, jnp.inf), axis=-1)
    pos = (n.astype(x.dtype) - 1.0) * prob
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, W - 1)
    hi = jnp.clip(lo + 1, 0, jnp.maximum(n - 1, 0))
    frac = pos - lo.astype(x.dtype)
    vlo = xs[:, lo]
    vhi = xs[:, hi]
    return vlo + frac * (vhi - vlo)


def init_state(target, q0, h0=0.2, delta0=0.05,
               warmup: WarmupConfig = WarmupConfig()) -> SamplerState:
    q0 = jnp.asarray(q0)
    C = q0.shape[0]
    dtype = q0.dtype
    lp, g = target.logp_grad(q0)
    return SamplerState(
        q=q0,
        lp=lp,
        g=g,
        h=jnp.full((C,), h0, dtype),
        delta=jnp.full((C,), delta0, dtype),
        p2=p2_init(1.0 - warmup.adapt_h_target, (C,), dtype),
        err_facs=jnp.zeros((C, max(warmup.warmup_iter, 1)), dtype),
        iter_n=jnp.zeros((), jnp.int32),
    )


def sampler_step(key, state: SamplerState, *, target, cfg: WalnutsConfig,
                 warmup: WarmupConfig, inv_mass=None):
    """One MCMC iteration + masked warmup adaptation."""
    it = state.iter_n + 1  # 1-based, like the reference loop
    in_warmup = it <= warmup.warmup_iter

    res = walnuts_transition(
        key, state.q, state.lp, state.g, state.h, state.delta, state.p2,
        in_warmup & warmup.adapt_h,
        target=target, cfg=cfg, inv_mass=inv_mass,
    )

    delta = state.delta
    err_facs = state.err_facs
    if warmup.adapt_delta:
        orbit_energy_error = res.diagnostics[:, 17]
        fac = orbit_energy_error / state.delta
        col = jnp.minimum(it - 1, err_facs.shape[1] - 1)
        err_facs = err_facs.at[:, col].set(
            jnp.where(in_warmup, fac, err_facs[:, col])
        )
        quant = masked_quantile(err_facs, it, warmup.adapt_delta_quantile)
        if warmup.pooled:
            # consensus: every chain adopts the batch-median quantile
            # (mean is dragged by the heavy tail of hard chains and
            # over-shrinks the tuning for the whole batch)
            quant = jnp.broadcast_to(jnp.median(quant), quant.shape)
        delta = jnp.where(
            in_warmup & (it > 10),
            warmup.adapt_delta_target / quant,
            delta,
        )

    h = state.h
    if warmup.adapt_h:
        log_c = p2_quantile(res.p2)
        if warmup.pooled:
            log_c = jnp.broadcast_to(jnp.median(log_c), log_c.shape)
        h_new = delta ** (1.0 / 3.0) * jnp.exp(log_c)
        h = jnp.where(in_warmup & (res.p2.npush > 10), h_new, h)

    new_state = SamplerState(
        q=res.q, lp=res.lp, g=res.g, h=h, delta=delta, p2=res.p2,
        err_facs=err_facs, iter_n=it,
    )
    return new_state, res


@partial(jax.jit,
         static_argnames=("target", "cfg", "warmup", "num_iter",
                          "collect_orbit_stats"))
def run_walnuts(
    key,
    q0,
    *,
    target,
    cfg: WalnutsConfig = WalnutsConfig(),
    warmup: WarmupConfig = WarmupConfig(),
    num_iter: int = 2000,
    h0: float = 0.2,
    delta0: float = 0.05,
    inv_mass=None,
    collect_orbit_stats: bool = False,
    resume_state: SamplerState = None,
):
    """Run ``num_iter`` WALNUTS iterations over a ``[C, D]`` chain batch.

    Returns ``(samples, diagnostics, state)`` where ``samples`` is
    ``[num_iter + 1, C, dg]`` (row 0 = initial positions, matching the
    reference layout ``WALNUTS.py:163-164``) and ``diagnostics`` is
    ``[num_iter, C, 24]``.

    ``resume_state``: continue exactly from a previous run's returned
    (or checkpointed, ``utils.checkpoint``) state — ``q0``, ``h0`` and
    ``delta0`` are ignored, and the iteration counter carries on so a
    split warmup behaves like one uninterrupted run.
    """
    if resume_state is not None:
        state = resume_state
        q0 = resume_state.q
    else:
        state = init_state(target, q0, h0, delta0, warmup)

    def step(st, i):
        k = jax.random.fold_in(key, i)
        st2, res = sampler_step(k, st, target=target, cfg=cfg,
                                warmup=warmup, inv_mass=inv_mass)
        out = (target.generated(res.q), res.diagnostics)
        if collect_orbit_stats:
            out = out + (res.orbit_min, res.orbit_max)
        return st2, out

    state, outs = jax.lax.scan(step, state, jnp.arange(1, num_iter + 1))
    gens, diags = outs[0], outs[1]
    samples = jnp.concatenate([target.generated(q0)[None], gens], axis=0)
    if collect_orbit_stats:
        return samples, diags, state, outs[2], outs[3]
    return samples, diags, state
