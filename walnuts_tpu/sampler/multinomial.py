"""Fixed-orbit-length multinomial sampler with the WASPS stop rule.

Replicates ``isokinetic/samplers.py:59-292`` as a batched fixed-shape
program:

* orbit length ``L`` fixed; the forward/backward split is random,
  ``nf ~ U{0..L-1}``, ``nb = L - 1 - nf`` (``samplers.py:135-136``);
* per direction, macro steps from a pluggable step kernel accumulate
  a log-weight sum; a direction dies when the accumulated sum falls
  below ``LOG_ZERO + 10`` (``samplers.py:176-178``);
* **WASPS stop** (random-plane-crossing): with per-iteration random
  directions ``eta`` (scaled by ``1/||z||^2``) and ``gam``
  (orthogonalised against ``eta``), a direction stops when the ``eta``
  projection of ``q - center`` changes sign across a step AND the
  ``gam`` projection is positive at either end
  (``samplers.py:124-129,180-188``);
* online multinomial selection with weights
  ``exp(Ham_0 - Ham_i + accLogWtSum)`` against a running sum seeded by
  the centre state's unit weight (``samplers.py:151-201``) — done in
  log space here;
* warmup: ``delta`` by dual averaging toward an ESS-fraction target
  and ``hMacro = (delta / exp(P2_q(log Cobs)))^(1/3)``
  (``samplers.py:259-268``);
* optional per-coordinate pre-scaling ``scale`` (``samplers.py:72-80``)
  and whole-orbit min/max statistics (``samplers.py:146-151``).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import LOG_ZERO
from ..utils.dual_average import da_init, da_observe, da_par
from ..utils.p2 import p2_init, p2_push, p2_quantile
from .kernels import IsokineticKernel

DIAG_COLS = ["h", "numForw", "sampleIndex", "deF", "deB", "lwtRange",
             "nSteps", "ESSfrac", "delta", "gradEvals", "energyErr",
             "minIf", "maxIf", "propBasic"]


class MultinomialConfig(NamedTuple):
    """Static configuration (``multinomialSampler`` kwargs,
    ``samplers.py:59-69``)."""

    l_orbit: int = 20
    wasps: bool = True
    ess_target: float = 0.99
    basic_target: float = 0.9


def _wasps_vectors(key, shape, dtype):
    """eta, gam as in ``samplers.py:124-129`` (note the 1/||z||^2
    scaling — magnitudes cancel in the sign-based stop rule)."""
    k1, k2 = jax.random.split(key)
    z1 = jax.random.normal(k1, shape, dtype)
    z2 = jax.random.normal(k2, shape, dtype)
    eta = z1 / jnp.sum(z1 * z1, axis=-1, keepdims=True)
    z2 = z2 - jnp.sum(z2 * eta, axis=-1, keepdims=True) * eta
    gam = z2 / jnp.sum(z2 * z2, axis=-1, keepdims=True)
    return eta, gam


def _direction_sweep(key, target, kernel, s0, ham0, n_steps, h, delta,
                     eta, gam, cen, cfg, sign, orbit_min, orbit_max,
                     gen_fn, l_max):
    """One direction's masked sweep of up to ``l_max`` macro steps.

    Returns the selected state/index (online multinomial *within* this
    direction — merged across directions by the caller), the log weight
    sum, per-direction stats, and updated orbit stats.
    """
    C, D = s0.q.shape
    dtype = s0.q.dtype

    class Sweep(NamedTuple):
        i: jnp.ndarray
        s: jnp.ndarray  # pytree MCState
        stopped: jnp.ndarray
        dead: jnp.ndarray
        acc_lwt: jnp.ndarray
        log_mn_sum: jnp.ndarray      # log of this direction's weight sum
        q_sel: jnp.ndarray
        lp_sel: jnp.ndarray
        g_sel: jnp.ndarray
        idx_sel: jnp.ndarray
        n_done: jnp.ndarray
        lwt_min: jnp.ndarray
        lwt_max: jnp.ndarray
        sum_w: jnp.ndarray           # direct sum of normalised weights
        sum_w2: jnp.ndarray
        n_used: jnp.ndarray
        n_evals: jnp.ndarray
        cobs_p2: jnp.ndarray         # placeholder; P2 handled by caller
        omin: jnp.ndarray
        omax: jnp.ndarray
        key: jnp.ndarray

    def cond(c):
        return jnp.any((c.i < n_steps) & ~c.stopped & ~c.dead)

    def body(c):
        key_step, key_sel, key_next = jax.random.split(c.key, 3)
        active = (c.i < n_steps) & ~c.stopped & ~c.dead
        q_old = c.s.q
        s_new, lwt_step, stats = kernel.step(
            key_step, target, c.s, h, delta, active)
        acc_lwt = c.acc_lwt + jnp.where(active, lwt_step, 0.0)
        dead = c.dead | (active & (acc_lwt < LOG_ZERO + 10.0))

        # WASPS plane-crossing stop (``samplers.py:180-188``)
        if cfg.wasps:
            cqs = s_new.q - cen
            cq = q_old - cen
            p1s = jnp.sum(cqs * eta, axis=-1)
            p1 = jnp.sum(cq * eta, axis=-1)
            p2s = jnp.sum(cqs * gam, axis=-1)
            p2 = jnp.sum(cq * gam, axis=-1)
            stop_now = active & ~dead & (p1s * p1 < 0.0) & (
                jnp.maximum(p2s, p2) > 0.0)
        else:
            stop_now = jnp.zeros((C,), bool)
        stopped = c.stopped | stop_now

        # states that died or stopped contribute no weight
        use = active & ~dead & ~stop_now
        ham_new = kernel.ham(s_new)
        lwt = jnp.where(
            use & jnp.isfinite(ham_new), ham0 - ham_new + acc_lwt, -jnp.inf)
        log_mn_sum = jnp.where(use, jnp.logaddexp(c.log_mn_sum, lwt),
                               c.log_mn_sum)
        u = jax.random.uniform(key_sel, (C,), dtype)
        sel = use & (jnp.log(jnp.maximum(u, 1e-300)) < lwt - log_mn_sum)

        w = jnp.where(use, jnp.exp(jnp.minimum(lwt, 80.0)), 0.0)
        idx = sign * (c.i + 1)

        s_keep = jax.tree.map(
            lambda n, o: jnp.where(
                active.reshape((C,) + (1,) * (n.ndim - 1)), n, o),
            s_new, c.s)

        if gen_fn is not None:
            gen = gen_fn(s_new.q)
            omin = jnp.where(use[:, None], jnp.minimum(c.omin, gen), c.omin)
            omax = jnp.where(use[:, None], jnp.maximum(c.omax, gen), c.omax)
        else:
            omin, omax = c.omin, c.omax

        return Sweep(
            i=c.i + 1, s=s_keep, stopped=stopped, dead=dead,
            acc_lwt=acc_lwt, log_mn_sum=log_mn_sum,
            q_sel=jnp.where(sel[:, None], s_new.q, c.q_sel),
            lp_sel=jnp.where(sel, s_new.lp, c.lp_sel),
            g_sel=jnp.where(sel[:, None], s_new.g, c.g_sel),
            idx_sel=jnp.where(sel, idx, c.idx_sel),
            n_done=c.n_done + use.astype(jnp.int32),
            lwt_min=jnp.where(use, jnp.minimum(c.lwt_min, lwt), c.lwt_min),
            lwt_max=jnp.where(use, jnp.maximum(c.lwt_max, lwt), c.lwt_max),
            sum_w=c.sum_w + w,
            sum_w2=c.sum_w2 + w * w,
            n_used=c.n_used + use.astype(jnp.int32),
            n_evals=c.n_evals + stats.n_evals,
            cobs_p2=jnp.where(use, jnp.maximum(c.cobs_p2, stats.c_obs),
                              c.cobs_p2),
            omin=omin, omax=omax, key=key_next,
        )

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    init = Sweep(
        i=zi, s=s0, stopped=jnp.zeros((C,), bool),
        dead=jnp.zeros((C,), bool), acc_lwt=zf,
        log_mn_sum=jnp.full((C,), -jnp.inf, dtype),
        q_sel=s0.q, lp_sel=s0.lp, g_sel=s0.g, idx_sel=zi,
        n_done=zi, lwt_min=jnp.full((C,), jnp.inf, dtype),
        lwt_max=jnp.full((C,), -jnp.inf, dtype),
        sum_w=zf, sum_w2=zf, n_used=zi, n_evals=zi, cobs_p2=zf,
        omin=orbit_min, omax=orbit_max, key=key,
    )
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("target", "kernel", "cfg", "num_iter",
                                   "warmup_iter", "collect_orbit_stats"))
def run_multinomial(key, q0, *, target, kernel=IsokineticKernel(),
                    cfg: MultinomialConfig = MultinomialConfig(),
                    h0=0.1, delta0=0.1, num_iter: int = 1000,
                    warmup_iter: int = 500, scale=1.0, center=0.0,
                    collect_orbit_stats: bool = False):
    """Run the fixed-orbit multinomial sampler over a ``[C, D]`` batch.

    Returns ``(samples [num_iter+1, C, dg], diagnostics
    [num_iter, C, 14], (h, delta) final)``.
    """
    q0 = jnp.asarray(q0)
    C, D = q0.shape
    dtype = q0.dtype
    L = cfg.l_orbit

    svec = jnp.broadcast_to(jnp.asarray(scale, dtype), (D,))
    cen = jnp.broadcast_to(jnp.asarray(center, dtype), (D,)) / svec

    # coordinate pre-scaling wrapper (``samplers.py:72-80``)
    class _Scaled:
        dim = D

        @staticmethod
        def logp_grad(q):
            lp, g = target.logp_grad(q * svec)
            return lp, g * svec

    scaled = _Scaled()

    state = kernel.init(scaled, q0 / svec)
    h = jnp.full((C,), h0, dtype)
    delta = jnp.full((C,), delta0, dtype)
    da = da_init(delta0, cfg.ess_target, (C,), dtype)
    p2 = p2_init(cfg.basic_target, (C,), dtype)

    def iteration(carry, it):
        state, h, delta, da, p2 = carry
        k = jax.random.fold_in(key, it)
        k_mom, k_nf, k_wasps, k_f, k_b, k_pick = jax.random.split(k, 6)

        s = kernel.refresh(k_mom, state)
        ham0 = kernel.ham(s)
        nf = jax.random.randint(k_nf, (C,), 0, L)
        nb = L - 1 - nf
        eta, gam = _wasps_vectors(k_wasps, (C, D), dtype)

        gen_fn = (lambda qq: target.generated(qq * svec)) \
            if collect_orbit_stats else None
        gen0 = (target.generated(s.q * svec) if collect_orbit_stats
                else jnp.zeros((C, 0), dtype))

        fw = _direction_sweep(k_f, scaled, kernel, s, ham0, nf, h, delta,
                              eta, gam, cen, cfg, 1, gen0, gen0, gen_fn, L)
        s_b = kernel.flip(s)
        bw = _direction_sweep(k_b, scaled, kernel, s_b, ham0, nb, h, delta,
                              eta, gam, cen, cfg, -1, fw.omin, fw.omax,
                              gen_fn, L)

        # merge the two directions' selections with the centre state:
        # total log weight sum includes the centre's weight exp(0)
        log_tot = jnp.logaddexp(0.0, jnp.logaddexp(fw.log_mn_sum,
                                                   bw.log_mn_sum))
        # P(pick forward candidate) = exp(log_f - log_tot), etc.
        u = jax.random.uniform(k_pick, (C,), dtype)
        lu = jnp.log(jnp.maximum(u, 1e-300))
        pick_f = lu < fw.log_mn_sum - log_tot
        pick_b = ~pick_f & (
            lu < jnp.logaddexp(fw.log_mn_sum, bw.log_mn_sum) - log_tot)
        q_new = jnp.where(pick_f[:, None], fw.q_sel,
                          jnp.where(pick_b[:, None], bw.q_sel, s.q))
        lp_new = jnp.where(pick_f, fw.lp_sel,
                           jnp.where(pick_b, bw.lp_sel, s.lp))
        g_new = jnp.where(pick_f[:, None], fw.g_sel,
                          jnp.where(pick_b[:, None], bw.g_sel, s.g))
        idx = jnp.where(pick_f, fw.idx_sel,
                        jnp.where(pick_b, bw.idx_sel, 0))
        # the backward flip means bw velocities point backward; the
        # next iteration refreshes momentum anyway, so store u = 0
        state_new = state._replace(q=q_new, u=jnp.zeros_like(q_new),
                                   g=g_new, lp=lp_new)

        # ESS fraction of the multinomial weights (``samplers.py:254-257``);
        # centre state contributes weight 1
        sum_w = 1.0 + fw.sum_w + bw.sum_w
        sum_w2 = 1.0 + fw.sum_w2 + bw.sum_w2
        n_used = 1 + fw.n_used + bw.n_used
        ess_frac = sum_w**2 / (n_used.astype(dtype) * sum_w2)

        # warmup adaptation (``samplers.py:259-268``)
        in_warm = it <= warmup_iter
        da2 = da_observe(da, ess_frac, mask=in_warm)
        delta2 = jnp.where(in_warm & (it > 10), da_par(da2), delta)
        cobs = jnp.maximum(jnp.maximum(fw.cobs_p2, bw.cobs_p2), 1e-30)
        p22 = p2_push(p2, jnp.log(cobs), mask=in_warm)
        h2 = jnp.where(
            in_warm & (it > 10),
            (delta2 / jnp.exp(p2_quantile(p22))) ** (1.0 / 3.0), h)

        lwt_min = jnp.minimum(fw.lwt_min, bw.lwt_min)
        lwt_max = jnp.maximum(fw.lwt_max, bw.lwt_max)
        lwt_range = jnp.where(jnp.isfinite(lwt_min), lwt_max - lwt_min, 0.0)
        diag = jnp.stack([
            h, nf.astype(dtype), idx.astype(dtype),
            fw.dead.astype(dtype),
            bw.dead.astype(dtype),
            lwt_range,
            (fw.n_done + bw.n_done).astype(dtype),
            ess_frac, delta,
            (fw.n_evals + bw.n_evals).astype(dtype),
            jnp.zeros((C,), dtype),  # energyErr detail lives in kernels
            jnp.zeros((C,), dtype),
            jnp.zeros((C,), dtype),
            jnp.zeros((C,), dtype),
        ], axis=-1)

        out = (target.generated(q_new * svec), diag, bw.omin, bw.omax)
        return (state_new, h2, delta2, da2, p22), out

    init = (state, h, delta, da, p2)
    (state, h, delta, da, p2), outs = jax.lax.scan(
        iteration, init, jnp.arange(1, num_iter + 1))
    gens, diags, omins, omaxs = outs
    samples = jnp.concatenate([target.generated(q0)[None], gens], axis=0)
    if collect_orbit_stats:
        return samples, diags, (h, delta), omins, omaxs
    return samples, diags, (h, delta)
