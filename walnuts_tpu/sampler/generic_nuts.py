"""Generic-step NUTS: orbit doubling over pluggable dynamics kernels.

Replicates the reference's OO research sampler ``NUTSampler``
(``isokinetic/WALNUTS.py:113-403``), which runs the same NUTS orbit
machinery over either Hamiltonian (``adaptHMCstepE``) or isokinetic
(``adaptMCstepE``) step objects; this covers the iWALNUTS variant of
the MATLAB line (``walnuts_imc/iwalnuts.m:1-95``) as well.

Semantics (matching ``buildOrbit``, ``isokinetic/WALNUTS.py:146-338``):

* per-state log weight ``lwts[i] = -Ham_i + cljac_dir`` where
  ``cljac`` accumulates the step kernel's returned log-weights
  (Jacobians + reversibility corrections) along each direction;
* within-suborbit unbiased online multinomial selection, then a
  *biased progressive* accept of the suborbit's candidate with
  probability ``subOrbitWtSum / accWtsum``;
* plan-driven sub-U-turn checks on the new suborbit interleaved with
  integration; any hit rejects the whole suborbit and stops
  (``NUTtype 1``); a joined-orbit U-turn stops after the accept
  (``NUTtype 0``); exhausting ``M`` doublings gives ``NUTtype 2``;
* the first integration leg is a single step in a random direction
  with an immediate accept test (``isokinetic/WALNUTS.py:174-215``).

Execution model: identical to :mod:`.transition` — the doubling
loop is flattened into ``build_schedule(M + 1)`` statically scheduled
steps under one ``lax.while_loop`` (the NUTSampler's ``M`` doublings
after a depth-0 single step are exactly a ``(M+1)``-depth schedule),
with a ``[C, S, D]`` checkpoint slab for merge checks.  Weight
bookkeeping runs in log space (``logaddexp``) instead of the
reference's ``exp(lwt - lwts[0])`` ratios — identical math, immune to
f32 overflow.  Selection randomness uses a deterministic
``fold_in(key, step)`` schedule.

Diagnostics columns (one row per chain per iteration):
``[NutsIter, L, a, b, aInt, bInt, NUTtype, gradEvals, energyErr,
minIf, maxIf, propBasic]`` — the reference's pandas row
(``isokinetic/WALNUTS.py:211,375-380`` + step ``diagnostics()``).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.hamiltonian import uturn
from ..ops.isokinetic import MCState
from .plans import build_schedule

DIAG_COLS = ["NutsIter", "L", "a", "b", "aInt", "bInt", "NUTtype",
             "gradEvals", "energyErr", "minIf", "maxIf", "propBasic"]

_NEG_INF = -jnp.inf


class _Carry(NamedTuple):
    t: jnp.ndarray
    sp: MCState
    sm: MCState
    cljac_p: jnp.ndarray
    cljac_m: jnp.ndarray
    # selection
    q_sel: jnp.ndarray
    lp_sel: jnp.ndarray
    g_sel: jnp.ndarray
    l_sel: jnp.ndarray
    q_sub: jnp.ndarray
    lp_sub: jnp.ndarray
    g_sub: jnp.ndarray
    l_sub: jnp.ndarray
    log_acc: jnp.ndarray
    log_sub: jnp.ndarray
    # orbit bounds
    a: jnp.ndarray
    b: jnp.ndarray
    a_new: jnp.ndarray
    b_new: jnp.ndarray
    # control
    done: jnp.ndarray
    depth_done: jnp.ndarray
    nuts_type: jnp.ndarray
    nuts_iter: jnp.ndarray
    # checkpoint slab
    slab_q: jnp.ndarray
    slab_v: jnp.ndarray
    # step-stat aggregates
    n_evals: jnp.ndarray
    e_err_max: jnp.ndarray
    if_min: jnp.ndarray
    if_max: jnp.ndarray
    n_basic: jnp.ndarray
    n_steps: jnp.ndarray


@partial(jax.jit, static_argnames=("target", "kernel", "m"))
def generic_nuts_transition(key, state: MCState, h_macro, delta, *,
                            target, kernel, m: int):
    """One NUTS transition over a generic step kernel for a ``[C, D]``
    batch.  ``m`` is the number of doublings after the initial single
    step (the reference's ``M``)."""
    C, D = state.q.shape
    dtype = state.q.dtype
    sched = build_schedule(m + 1)
    T = sched.n_steps
    S = sched.capacity

    tab = {
        name: jnp.asarray(getattr(sched, name))
        for name in ("depth", "slot1", "slot2", "last_of_depth", "is_depth0",
                     "post_slot_lo", "post_slot_hi", "post_valid")
    }
    first_of_depth = jnp.asarray(
        [True] + [bool(sched.depth[i] != sched.depth[i - 1])
                  for i in range(1, T)])

    k_mom, k_dirs, k_orbit = jax.random.split(key, 3)
    state = kernel.refresh(k_mom, state)
    ham0 = kernel.ham(state)
    lwt0 = -ham0

    xi_all = jax.random.bernoulli(k_dirs, 0.5, (C, m + 1))

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    zb = jnp.zeros((C,), bool)
    big_i = jnp.full((C,), 2**30, jnp.int32)

    carry = _Carry(
        t=jnp.zeros((), jnp.int32),
        sp=state, sm=state, cljac_p=zf, cljac_m=zf,
        q_sel=state.q, lp_sel=state.lp, g_sel=state.g, l_sel=zi,
        q_sub=state.q, lp_sub=state.lp, g_sub=state.g, l_sub=zi,
        log_acc=zf, log_sub=jnp.full((C,), _NEG_INF, dtype),
        a=zi, b=zi, a_new=zi, b_new=zi,
        done=zb, depth_done=zb, nuts_type=jnp.full((C,), 2, jnp.int32),
        nuts_iter=zi,
        slab_q=jnp.zeros((C, S, D), dtype),
        slab_v=jnp.zeros((C, S, D), dtype),
        n_evals=zi, e_err_max=zf, if_min=big_i, if_max=-big_i,
        n_basic=zi, n_steps=zi,
    )

    def _one_step(c, key_i, key_sel, fwd, slot, active, is_d0, h_macro):
        """Integrate one macro step from the active end of each chain,
        update weights/selection, checkpoint into the slab."""
        end = jax.tree.map(
            lambda p, m_: jnp.where(
                fwd.reshape((C,) + (1,) * (p.ndim - 1)), p, m_),
            c.sp, c.sm)
        # backward integration flips, steps, flips back
        # (``isokinetic/WALNUTS.py:283-287``)
        end_in = end._replace(u=jnp.where(fwd[:, None], end.u, -end.u))
        new, lwt_step, stats = kernel.step(
            key_i, target, end_in, h_macro, delta, active)
        new = new._replace(
            u=jnp.where(fwd[:, None], new.u, -new.u))

        af, ab = active & fwd, active & ~fwd
        sp = jax.tree.map(
            lambda n, p: jnp.where(
                af.reshape((C,) + (1,) * (n.ndim - 1)), n, p), new, c.sp)
        sm = jax.tree.map(
            lambda n, m_: jnp.where(
                ab.reshape((C,) + (1,) * (n.ndim - 1)), n, m_), new, c.sm)
        cljac_p = c.cljac_p + jnp.where(af, lwt_step, 0.0)
        cljac_m = c.cljac_m + jnp.where(ab, lwt_step, 0.0)

        cljac = jnp.where(fwd, cljac_p, cljac_m)
        ham = kernel.ham(new)
        wt_log = jnp.where(jnp.isfinite(ham), -ham + cljac - lwt0, _NEG_INF)

        log_sub = jnp.where(
            active, jnp.logaddexp(c.log_sub, wt_log), c.log_sub)
        abs_id = jnp.where(fwd, c.b_new + 1, c.a_new - 1)

        u = jax.random.uniform(key_sel, (C,), dtype)
        # depth 0: accept directly into the sampled state vs accWtsum
        # (``isokinetic/WALNUTS.py:186-207``); deeper: within-suborbit
        # online multinomial (``:245-250``)
        p_log = jnp.where(is_d0, wt_log - c.log_acc, wt_log - log_sub)
        sel = active & (jnp.log(jnp.maximum(u, 1e-300)) < p_log)
        sel_d0 = sel & is_d0
        sel_sub = sel & ~is_d0
        c = c._replace(
            sp=sp, sm=sm, cljac_p=cljac_p, cljac_m=cljac_m,
            log_sub=log_sub,
            a_new=jnp.where(ab, c.a_new - 1, c.a_new),
            b_new=jnp.where(af, c.b_new + 1, c.b_new),
            q_sel=jnp.where(sel_d0[:, None], new.q, c.q_sel),
            lp_sel=jnp.where(sel_d0, new.lp, c.lp_sel),
            g_sel=jnp.where(sel_d0[:, None], new.g, c.g_sel),
            l_sel=jnp.where(sel_d0, abs_id, c.l_sel),
            q_sub=jnp.where(sel_sub[:, None], new.q, c.q_sub),
            lp_sub=jnp.where(sel_sub, new.lp, c.lp_sub),
            g_sub=jnp.where(sel_sub[:, None], new.g, c.g_sub),
            l_sub=jnp.where(sel_sub, abs_id, c.l_sub),
            slab_q=c.slab_q.at[:, slot, :].set(
                jnp.where(active[:, None], new.q, c.slab_q[:, slot, :])),
            slab_v=c.slab_v.at[:, slot, :].set(
                jnp.where(active[:, None], kernel.velocity(new),
                          c.slab_v[:, slot, :])),
            n_evals=c.n_evals + stats.n_evals,
            e_err_max=jnp.where(
                active,
                jnp.maximum(c.e_err_max, jnp.abs(stats.energy_err)),
                c.e_err_max),
            if_min=jnp.where(active, jnp.minimum(c.if_min, stats.i_f),
                             c.if_min),
            if_max=jnp.where(active, jnp.maximum(c.if_max, stats.i_f),
                             c.if_max),
            n_basic=c.n_basic + (active & stats.basic).astype(jnp.int32),
            n_steps=c.n_steps + active.astype(jnp.int32),
        )
        return c, new

    def cond(c):
        return (c.t < T) & jnp.any(~c.done)

    def body(c):
        t = c.t
        depth_t = tab["depth"][t]
        slot1 = tab["slot1"][t]
        slot2 = tab["slot2"][t]
        last = tab["last_of_depth"][t]
        is_d0 = tab["is_depth0"][t]
        first = first_of_depth[t]

        fwd = xi_all[:, depth_t]

        key_t = jax.random.fold_in(k_orbit, t)
        k_i1, k_i2, k_s1, k_s2, k_acc = jax.random.split(key_t, 5)

        # new suborbit begins: fold the previous suborbit's weight into
        # the accepted-orbit sum (``isokinetic/WALNUTS.py:219-221``)
        snap = first & ~is_d0 & ~c.done
        c = c._replace(
            log_acc=jnp.where(snap, jnp.logaddexp(c.log_acc, c.log_sub),
                              c.log_acc),
            log_sub=jnp.where(snap, _NEG_INF, c.log_sub),
        )

        alive = ~c.done & ~c.depth_done

        c, s1 = _one_step(c, k_i1, k_s1, fwd, slot1, alive, is_d0,
                          h_macro)
        act2 = alive & ~is_d0
        c, s2 = _one_step(c, k_i2, k_s2, fwd, slot2, act2,
                          jnp.zeros((), bool), h_macro)

        # adjacent U-turn between the two new states (earlier state
        # first in orbit time)
        v1, v2 = kernel.velocity(s1), kernel.velocity(s2)
        eq = jnp.where(fwd[:, None], s1.q, s2.q)
        ev = jnp.where(fwd[:, None], v1, v2)
        lq = jnp.where(fwd[:, None], s2.q, s1.q)
        lv = jnp.where(fwd[:, None], v2, v1)
        depth_done = c.depth_done | (act2 & uturn(eq, ev, lq, lv))

        # merge checks from the slab
        for kk in range(sched.max_post):
            pv = tab["post_valid"][t, kk]
            slo = tab["post_slot_lo"][t, kk]
            shi = tab["post_slot_hi"][t, kk]
            meq = jnp.where(fwd[:, None], c.slab_q[:, slo, :],
                            c.slab_q[:, shi, :])
            mev = jnp.where(fwd[:, None], c.slab_v[:, slo, :],
                            c.slab_v[:, shi, :])
            mlq = jnp.where(fwd[:, None], c.slab_q[:, shi, :],
                            c.slab_q[:, slo, :])
            mlv = jnp.where(fwd[:, None], c.slab_v[:, shi, :],
                            c.slab_v[:, slo, :])
            depth_done = depth_done | (pv & act2 & uturn(meq, mev, mlq, mlv))

        # suborbit rejected by sub-U-turn: stop, keep current sample
        # (``isokinetic/WALNUTS.py:256-261``)
        newly_su = (depth_done & ~c.depth_done) & ~c.done & ~is_d0
        c = c._replace(
            depth_done=depth_done,
            nuts_type=jnp.where(newly_su, 1, c.nuts_type),
            nuts_iter=jnp.where(newly_su, depth_t, c.nuts_iter),
            done=c.done | newly_su,
        )

        # depth end: biased progressive accept + global U-turn
        p_mask = last & ~c.done & ~c.depth_done
        u_acc = jax.random.uniform(k_acc, (C,), dtype)
        take = p_mask & ~is_d0 & (
            jnp.log(jnp.maximum(u_acc, 1e-300)) < c.log_sub - c.log_acc)
        joined = uturn(c.sm.q, kernel.velocity(c.sm),
                       c.sp.q, kernel.velocity(c.sp))
        stop_g = p_mask & joined
        c = c._replace(
            q_sel=jnp.where(take[:, None], c.q_sub, c.q_sel),
            lp_sel=jnp.where(take, c.lp_sub, c.lp_sel),
            g_sel=jnp.where(take[:, None], c.g_sub, c.g_sel),
            l_sel=jnp.where(take, c.l_sub, c.l_sel),
            nuts_type=jnp.where(stop_g, 0, c.nuts_type),
            nuts_iter=jnp.where(p_mask, depth_t, c.nuts_iter),
            done=c.done | stop_g,
            a=jnp.where(p_mask, c.a_new, c.a),
            b=jnp.where(p_mask, c.b_new, c.b),
            depth_done=jnp.where(last, False, c.depth_done),
        )
        return c._replace(t=t + 1)

    carry = jax.lax.while_loop(cond, body, carry)

    nst = jnp.maximum(carry.n_steps, 1).astype(dtype)
    diag = jnp.stack([
        carry.nuts_iter.astype(dtype),
        carry.l_sel.astype(dtype),
        carry.a.astype(dtype),
        carry.b.astype(dtype),
        carry.a_new.astype(dtype),
        carry.b_new.astype(dtype),
        carry.nuts_type.astype(dtype),
        carry.n_evals.astype(dtype),
        carry.e_err_max,
        carry.if_min.astype(dtype),
        carry.if_max.astype(dtype),
        carry.n_basic.astype(dtype) / nst,
    ], axis=-1)

    new_state = MCState(carry.q_sel, jnp.zeros_like(carry.q_sel),
                        carry.g_sel, carry.lp_sel)
    return new_state, diag


@partial(jax.jit, static_argnames=("target", "kernel", "m", "num_iter"))
def run_generic_nuts(key, q0, *, target, kernel, h_macro, delta,
                     num_iter: int, m: int = 10):
    """Chain driver (``NUTSampler.run``, ``isokinetic/WALNUTS.py:341-385``):
    fixed tuning, full momentum refresh per iteration.

    Returns ``(samples [num_iter+1, C, dg], diagnostics
    [num_iter, C, 12])``.
    """
    q0 = jnp.asarray(q0)
    C = q0.shape[0]
    dtype = q0.dtype
    state = kernel.init(target, q0)
    h = jnp.full((C,), h_macro, dtype)
    d = jnp.full((C,), delta, dtype)

    def step(st, i):
        k = jax.random.fold_in(key, i)
        st2, diag = generic_nuts_transition(
            k, st, h, d, target=target, kernel=kernel, m=m)
        return st2, (target.generated(st2.q), diag)

    state, (gens, diags) = jax.lax.scan(
        step, state, jnp.arange(1, num_iter + 1))
    samples = jnp.concatenate([target.generated(q0)[None], gens], axis=0)
    return samples, diags
