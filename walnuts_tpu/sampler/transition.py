"""The WALNUTS Markov transition as a fixed-shape batched program.

Semantics replicate the reference's instrumented research sampler
(``WALNUTSpy/WALNUTS.py:111-727``): biased-progressive orbit doubling
with interleaved sub-U-turn checks, online categorical proposal
selection with ``LOG_ZERO`` weight guards, per-macro-step step-size
jitter, stop codes {0, 4, -4, 5, 999}, warmup statistics, and the
24-column diagnostics contract (``WALNUTS.py:670-693``).

The *execution model* is inverted for a batched accelerator:

* One call advances ``C`` chains at once; every array carries a chain
  axis and all control flow is masked.
* The doubling loop and its per-depth check plans are flattened into a
  single ``lax.while_loop`` over ``2^(M-1)`` statically scheduled steps
  (``plans.build_schedule``): step 0 is the depth-0 macro step, later
  steps integrate one forward-or-backward *pair* of macro steps, run
  the adjacent U-turn check, then up to ``M-2`` masked merge checks
  that read checkpoint states from a ``[C, capacity, D]`` slab at
  trace-time-resolved slots.  The loop exits as soon as every chain
  has stopped, so short orbits don't pay for the worst case.
* Each chain consumes randomness through a deterministic
  ``fold_in(key, step)`` schedule instead of the reference's
  data-dependent draw order — distributionally equivalent, and
  independent of how many chains share the batch.

Documented behavioural deviations from the reference (each inline):

* the selected-state index statistic (diag col 23) is always
  normalised from the raw selected time at depth end, avoiding the
  reference's re-normalisation of an already-normalised value when a
  depth selects no new proposal (``WALNUTS.py:595``);
* a non-finite Hamiltonian on the *second* macro step of a pair
  records stop code 999 like the first — the reference forgets to set
  it there (``WALNUTS.py:457-459``).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..ops.integrators import IntegratorConfig, get_integrator
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from ..utils.p2 import P2State, p2_push
from .plans import build_schedule

_BIG_I32 = 2 ** 30          # plain int: no device array at import


class WalnutsConfig(NamedTuple):
    """Static sampler configuration (hashable; safe to close over jit).

    Mirrors the keyword surface of ``WALNUTSpy/WALNUTS.py:111-129``.
    """

    m: int = 10
    integrator: str = "adapt_leapfrog_r2p"
    igr: IntegratorConfig = IntegratorConfig()
    step_size_rand_scale: float = 0.2
    record_orbit_stats: bool = False
    use_inv_mass: bool = False  # identity metric by default (WALNUTSpy)


class TransitionResult(NamedTuple):
    q: jnp.ndarray
    lp: jnp.ndarray
    g: jnp.ndarray
    diagnostics: jnp.ndarray  # [C, 24]
    p2: P2State
    orbit_min: jnp.ndarray    # [C, dg] ([C, 0] when disabled)
    orbit_max: jnp.ndarray


class _Carry(NamedTuple):
    t: jnp.ndarray
    # endpoints (orbit-time-oriented velocities)
    qp: jnp.ndarray
    vp: jnp.ndarray
    gp: jnp.ndarray
    lpp: jnp.ndarray
    hp: jnp.ndarray
    qm: jnp.ndarray
    vm: jnp.ndarray
    gm: jnp.ndarray
    lpm: jnp.ndarray
    hm: jnp.ndarray
    # proposal and its depth-start snapshot
    q_prop: jnp.ndarray
    lp_prop: jnp.ndarray
    g_prop: jnp.ndarray
    q_prop_last: jnp.ndarray
    lp_prop_last: jnp.ndarray
    g_prop_last: jnp.ndarray
    # selection bookkeeping
    mscale: jnp.ndarray
    lwt_sum_f: jnp.ndarray
    lwt_sum_b: jnp.ndarray
    w_new_sum: jnp.ndarray
    w_old_sum: jnp.ndarray
    sel_l: jnp.ndarray
    sel_l_old: jnp.ndarray
    idx_time: jnp.ndarray
    index_stat: jnp.ndarray
    index_stat_old: jnp.ndarray
    time_f: jnp.ndarray
    time_b: jnp.ndarray
    orbit_len: jnp.ndarray
    orbit_len_sam: jnp.ndarray
    a_abs: jnp.ndarray
    b_abs: jnp.ndarray
    # control flags
    done: jnp.ndarray
    depth_done: jnp.ndarray
    stop_code: jnp.ndarray
    both_ends_passive: jnp.ndarray
    n_doubl_sampled: jnp.ndarray
    n_doubl_computed: jnp.ndarray
    max_f_int: jnp.ndarray
    max_b_int: jnp.ndarray
    # diagnostics aggregates over computed states
    neval_f: jnp.ndarray
    neval_b: jnp.ndarray
    h_min: jnp.ndarray
    h_max: jnp.ndarray
    if_min: jnp.ndarray
    if_max: jnp.ndarray
    c_min: jnp.ndarray
    c_max: jnp.ndarray
    lwt_min: jnp.ndarray
    lwt_max: jnp.ndarray
    n_states: jnp.ndarray
    n_if_neq_ib: jnp.ndarray
    n_if_zero: jnp.ndarray
    # warmup statistics
    p2: P2State
    # checkpoint slab for merge U-turn checks
    slab_q: jnp.ndarray  # [C, S, D]
    slab_v: jnp.ndarray
    # optional whole-orbit stats of generated quantities
    orbit_min: jnp.ndarray
    orbit_max: jnp.ndarray


def _mmin(cur, new, mask):
    return jnp.where(mask, jnp.minimum(cur, new), cur)


def _mmax(cur, new, mask):
    return jnp.where(mask, jnp.maximum(cur, new), cur)


@partial(jax.jit, static_argnames=("target", "cfg"))
def walnuts_transition(
    key,
    q,
    lp,
    g,
    h_step,
    delta,
    p2: P2State,
    warmup,
    *,
    target,
    cfg: WalnutsConfig,
    inv_mass=None,
):
    """One WALNUTS transition for a ``[C, D]`` chain batch.

    Args:
        key: PRNG key for this iteration (consumption is deterministic
            per (step, purpose); chains share keys but draw per-chain
            variates).
        q, lp, g: current positions with cached density/gradient.
        h_step: per-chain macro step size ``H``, shape ``[C]``.
        delta: per-chain integrator tolerance, shape ``[C]``.
        p2: per-chain P2 estimators of the log step-size constant,
            pushed once per computed macro step during warmup
            (reference ``WALNUTS.py:313``).
        warmup: traced bool — whether warmup statistics are collected.
        target: the Target (static).
        cfg: static sampler config.
        inv_mass: optional diagonal inverse mass ``[D]`` (used when
            ``cfg.use_inv_mass``).
    """
    C, D = q.shape
    dtype = q.dtype
    m = cfg.m
    sched = build_schedule(m)
    integrator = get_integrator(cfg.integrator)
    im = inv_mass if cfg.use_inv_mass else None

    k_mom, k_dirs, k_orbit = jax.random.split(key, 3)
    v0 = refresh_momentum(k_mom, (C, D), im, dtype)
    h0 = hamiltonian(lp, v0, im)

    # all doubling directions drawn up front (reference WALNUTS.py:216)
    xi_all = jnp.where(jax.random.bernoulli(k_dirs, 0.5, (C, m)), 1.0, -1.0)
    xi_all = xi_all.astype(dtype)

    T = sched.n_steps
    S = sched.capacity
    tab = {
        name: jnp.asarray(getattr(sched, name))
        for name in (
            "depth", "rel1", "rel2", "slot1", "slot2",
            "last_of_depth", "is_depth0", "post_slot_lo", "post_slot_hi",
            "post_valid",
        )
    }
    first_of_depth = jnp.asarray(
        [True] + [bool(sched.depth[i] != sched.depth[i - 1]) for i in range(1, T)]
    )

    gen0 = (
        target.generated(q)
        if cfg.record_orbit_stats
        else jnp.zeros((C, 0), dtype)
    )

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    zb = jnp.zeros((C,), bool)
    inf = jnp.asarray(jnp.inf, dtype)

    carry = _Carry(
        t=jnp.zeros((), jnp.int32),
        qp=q, vp=v0, gp=g, lpp=lp, hp=h0,
        qm=q, vm=v0, gm=g, lpm=lp, hm=h0,
        q_prop=q, lp_prop=lp, g_prop=g,
        q_prop_last=q, lp_prop_last=lp, g_prop_last=g,
        mscale=h0,
        lwt_sum_f=zf, lwt_sum_b=zf,
        w_new_sum=zf, w_old_sum=jnp.ones((C,), dtype),
        sel_l=zi, sel_l_old=zi,
        idx_time=zf, index_stat=zf, index_stat_old=zf,
        time_f=zf, time_b=zf,
        orbit_len=zf, orbit_len_sam=zf,
        a_abs=zi, b_abs=zi,
        done=zb, depth_done=zb,
        stop_code=zi, both_ends_passive=zb,
        n_doubl_sampled=zi, n_doubl_computed=zi,
        max_f_int=zi, max_b_int=zi,
        neval_f=zi, neval_b=zi,
        h_min=h0, h_max=h0,
        if_min=jnp.full((C,), _BIG_I32, jnp.int32), if_max=jnp.full((C,), -_BIG_I32, jnp.int32),
        c_min=jnp.full((C,), _BIG_I32, jnp.int32), c_max=jnp.full((C,), -_BIG_I32, jnp.int32),
        lwt_min=jnp.full((C,), inf), lwt_max=jnp.full((C,), -inf),
        n_states=zi, n_if_neq_ib=zi, n_if_zero=zi,
        p2=p2,
        slab_q=jnp.zeros((C, S, D), dtype),
        slab_v=jnp.zeros((C, S, D), dtype),
        orbit_min=gen0, orbit_max=gen0,
    )

    thresh = jnp.asarray(WT_SUM_THRESH, dtype)
    log_zero_edge = LOG_ZERO + 1.0

    def _integrate_once(c, key_i, key_cat, hloc, xi, fwd, rel, slot,
                        active, is_d0):
        """One macro step from each chain's active end, with all
        bookkeeping.  Returns (carry, (q_new, v_new), finite, ok)."""
        q_end = jnp.where(fwd[:, None], c.qp, c.qm)
        v_end = jnp.where(fwd[:, None], c.vp, c.vm)
        g_end = jnp.where(fwd[:, None], c.gp, c.gm)
        lp_end = jnp.where(fwd, c.lpp, c.lpm)
        h_end = jnp.where(fwd, c.hp, c.hm)

        res = integrator(key_i, target, q_end, v_end, g_end, lp_end, h_end,
                         hloc, xi, delta, im, active, cfg.igr)
        finite = jnp.isfinite(res.h_end)
        ok = active & finite

        af = active & fwd
        ab = active & ~fwd
        c = c._replace(
            qp=jnp.where(af[:, None], res.q, c.qp),
            vp=jnp.where(af[:, None], res.v, c.vp),
            gp=jnp.where(af[:, None], res.g, c.gp),
            lpp=jnp.where(af, res.lp, c.lpp),
            hp=jnp.where(af, res.h_end, c.hp),
            qm=jnp.where(ab[:, None], res.q, c.qm),
            vm=jnp.where(ab[:, None], res.v, c.vm),
            gm=jnp.where(ab[:, None], res.g, c.gm),
            lpm=jnp.where(ab, res.lp, c.lpm),
            hm=jnp.where(ab, res.h_end, c.hm),
        )

        abs_id = jnp.where(fwd, c.b_abs + rel, c.a_abs - rel)

        # aggregates recorded before the finiteness cut, matching the
        # reference's Hs/Ifs/cs/lwts array writes (WALNUTS.py:400-417)
        c = c._replace(
            neval_f=c.neval_f + jnp.where(active, res.n_eval_f, 0),
            neval_b=c.neval_b + jnp.where(active, res.n_eval_b, 0),
            h_min=_mmin(c.h_min, res.h_end, active),
            h_max=_mmax(c.h_max, res.h_end, active),
            if_min=_mmin(c.if_min, res.i_f, active),
            if_max=_mmax(c.if_max, res.i_f, active),
            c_min=_mmin(c.c_min, res.c, active),
            c_max=_mmax(c.c_max, res.c, active),
            lwt_min=_mmin(c.lwt_min, res.lwt, active),
            lwt_max=_mmax(c.lwt_max, res.lwt, active),
            n_states=c.n_states + active.astype(jnp.int32),
            n_if_neq_ib=c.n_if_neq_ib
            + (active & (res.i_f != res.i_b)).astype(jnp.int32),
            n_if_zero=c.n_if_zero + (active & (res.i_f == 0)).astype(jnp.int32),
            max_f_int=jnp.where(af, abs_id, c.max_f_int),
            max_b_int=jnp.where(ab, abs_id, c.max_b_int),
            time_f=c.time_f + jnp.where(af, hloc, 0.0),
            time_b=c.time_b + jnp.where(ab, hloc, 0.0),
            # the P2 marker update is ~80 small ops; skip the whole
            # computation outside warmup (scalar-pred cond)
            p2=jax.lax.cond(
                warmup,
                lambda p2: p2_push(p2, jnp.log(res.igr_const),
                                   mask=active & warmup),
                lambda p2: p2,
                c.p2),
        )

        # weight bookkeeping; reference accumulates only finite states
        # (the non-finite break precedes lwtSum updates, WALNUTS.py:414-420)
        lwt_sum_f = c.lwt_sum_f + jnp.where(ok & fwd, res.lwt, 0.0)
        lwt_sum_b = c.lwt_sum_b + jnp.where(ok & ~fwd, res.lwt, 0.0)
        lwt_dir = jnp.where(fwd, lwt_sum_f, lwt_sum_b)
        w_new = jnp.exp(-res.h_end + c.mscale + lwt_dir)
        w_new_sum = c.w_new_sum + jnp.where(ok, w_new, 0.0)

        # online categorical selection (WALNUTS.py:422-429); at depth 0
        # the proposal is replaced unconditionally instead
        # (WALNUTS.py:326-329)
        u = jax.random.uniform(key_cat, (C,), dtype)
        sel = ok & (w_new_sum > thresh) & (u * w_new_sum < w_new) & ~is_d0
        sel = sel | (ok & is_d0)
        signed_time = jnp.where(fwd, c.time_f, -c.time_b)

        # depth-0 orbit length counts the jittered step even when the
        # new Hamiltonian is non-finite (WALNUTS.py:298-300); at deeper
        # levels it is only counted for finite states (WALNUTS.py:432)
        olen_mask = jnp.where(is_d0, active, ok)

        sel1 = sel[:, None]
        c = c._replace(
            lwt_sum_f=lwt_sum_f,
            lwt_sum_b=lwt_sum_b,
            w_new_sum=w_new_sum,
            q_prop=jnp.where(sel1, res.q, c.q_prop),
            lp_prop=jnp.where(sel, res.lp, c.lp_prop),
            g_prop=jnp.where(sel1, res.g, c.g_prop),
            sel_l=jnp.where(sel, abs_id, c.sel_l),
            idx_time=jnp.where(sel, signed_time, c.idx_time),
            orbit_len=c.orbit_len + jnp.where(olen_mask, hloc, 0.0),
        )

        # checkpoint the new state for future merge checks
        c = c._replace(
            slab_q=c.slab_q.at[:, slot, :].set(
                jnp.where(ok[:, None], res.q, c.slab_q[:, slot, :])
            ),
            slab_v=c.slab_v.at[:, slot, :].set(
                jnp.where(ok[:, None], res.v, c.slab_v[:, slot, :])
            ),
        )

        if cfg.record_orbit_stats:
            gen = target.generated(res.q)
            c = c._replace(
                orbit_min=jnp.where(ok[:, None],
                                    jnp.minimum(c.orbit_min, gen),
                                    c.orbit_min),
                orbit_max=jnp.where(ok[:, None],
                                    jnp.maximum(c.orbit_max, gen),
                                    c.orbit_max),
            )

        return c, (res.q, res.v), finite, ok

    def cond(c):
        return (c.t < T) & jnp.any(~c.done)

    def body(c):
        t = c.t
        depth_t = tab["depth"][t]
        rel1 = tab["rel1"][t]
        rel2 = tab["rel2"][t]
        slot1 = tab["slot1"][t]
        slot2 = tab["slot2"][t]
        last = tab["last_of_depth"][t]
        is_d0 = tab["is_depth0"][t]
        first = first_of_depth[t]

        xi = xi_all[:, depth_t]
        fwd = xi > 0

        key_t = jax.random.fold_in(k_orbit, t)
        k_h, k_i1, k_i2, k_c1, k_c2, k_acc = jax.random.split(key_t, 6)
        s = cfg.step_size_rand_scale
        hloc = h_step[:, None] * jax.random.uniform(
            k_h, (C, 2), dtype, 1.0 - s, 1.0 + s
        )

        # ---- depth-start snapshot (reference WALNUTS.py:291-295) ----
        snap = first & ~c.done
        c = c._replace(
            q_prop_last=jnp.where(snap[:, None], c.q_prop, c.q_prop_last),
            lp_prop_last=jnp.where(snap, c.lp_prop, c.lp_prop_last),
            g_prop_last=jnp.where(snap[:, None], c.g_prop, c.g_prop_last),
            sel_l_old=jnp.where(snap, c.sel_l, c.sel_l_old),
            index_stat_old=jnp.where(snap, c.index_stat, c.index_stat_old),
            w_new_sum=jnp.where(snap, 0.0, c.w_new_sum),
        )

        alive = ~c.done & ~c.depth_done

        # ---- first macro step of the pair ----
        c, (q1, v1), finite1, ok1 = _integrate_once(
            c, k_i1, k_c1, hloc[:, 0], xi, fwd, rel1, slot1, alive, is_d0)
        forced1 = alive & ~finite1

        # ---- second macro step (pairs only) ----
        act2 = ok1 & ~is_d0
        c, (q2, v2), finite2, ok2 = _integrate_once(
            c, k_i2, k_c2, hloc[:, 1], xi, fwd, rel2, slot2, act2,
            jnp.zeros((), bool))
        forced2 = act2 & ~finite2
        forced = forced1 | forced2

        # ---- adjacent U-turn check between the two new states ----
        # temporally earlier state: rel1 when forward, rel2 when backward
        chk = ok2
        eq = jnp.where(fwd[:, None], q1, q2)
        ev = jnp.where(fwd[:, None], v1, v2)
        lq = jnp.where(fwd[:, None], q2, q1)
        lv = jnp.where(fwd[:, None], v2, v1)
        adj_ut = uturn(eq, ev, lq, lv, im)
        depth_done = c.depth_done | (chk & adj_ut)

        # ---- merge checks against slab checkpoints (WALNUTS.py:572-587)
        # most steps have no valid merge check; the scalar-pred cond
        # skips the [C, D] gathers and dot products entirely then
        for kk in range(sched.max_post):
            pv = tab["post_valid"][t, kk]
            slo = tab["post_slot_lo"][t, kk]
            shi = tab["post_slot_hi"][t, kk]

            def _merge_check(dd, slo=slo, shi=shi):
                q_lo = c.slab_q[:, slo, :]
                v_lo = c.slab_v[:, slo, :]
                q_hi = c.slab_q[:, shi, :]
                v_hi = c.slab_v[:, shi, :]
                meq = jnp.where(fwd[:, None], q_lo, q_hi)
                mev = jnp.where(fwd[:, None], v_lo, v_hi)
                mlq = jnp.where(fwd[:, None], q_hi, q_lo)
                mlv = jnp.where(fwd[:, None], v_hi, v_lo)
                m_ut = uturn(meq, mev, mlq, mlv, im)
                return dd | (ok2 & m_ut)

            depth_done = jax.lax.cond(
                pv, _merge_check, lambda dd: dd, depth_done)

        # ---- numerical problems: forced rejection, stop code 999 ----
        c = c._replace(
            depth_done=depth_done,
            stop_code=jnp.where(forced, 999, c.stop_code),
            done=c.done | forced,
        )

        # ---- depth-end resolution ----
        p_mask = last & ~c.done
        su = p_mask & c.depth_done          # sub-U-turn: doubling rejected
        go = p_mask & ~c.depth_done

        u_acc = jax.random.uniform(k_acc, (C,), dtype)
        keep_new = u_acc * c.w_old_sum < c.w_new_sum
        restore = su | (go & ~keep_new)
        c = c._replace(
            q_prop=jnp.where(restore[:, None], c.q_prop_last, c.q_prop),
            lp_prop=jnp.where(restore, c.lp_prop_last, c.lp_prop),
            g_prop=jnp.where(restore[:, None], c.g_prop_last, c.g_prop),
            sel_l=jnp.where(restore, c.sel_l_old, c.sel_l),
            index_stat=jnp.where(
                restore,
                c.index_stat_old,
                jnp.where(
                    p_mask,
                    c.idx_time / (c.time_f + c.time_b),
                    c.index_stat,
                ),
            ),
        )

        # sub-U-turn bookkeeping (WALNUTS.py:597-605)
        c = c._replace(
            n_doubl_sampled=jnp.where(su, depth_t, c.n_doubl_sampled),
            n_doubl_computed=jnp.where(su, depth_t + 1, c.n_doubl_computed),
            stop_code=jnp.where(su, 5, c.stop_code),
            done=c.done | su,
        )

        # joined-orbit U-turn / dead ends (WALNUTS.py:620-634)
        joined = uturn(c.qm, c.vm, c.qp, c.vp, im)
        passive = (c.lwt_sum_b < log_zero_edge) & (c.lwt_sum_f < log_zero_edge)
        stop_now = go & (joined | passive)
        c = c._replace(
            n_doubl_sampled=jnp.where(go, depth_t + 1, c.n_doubl_sampled),
            n_doubl_computed=jnp.where(go, depth_t + 1, c.n_doubl_computed),
            orbit_len_sam=jnp.where(go, c.orbit_len, c.orbit_len_sam),
            both_ends_passive=jnp.where(go, passive, c.both_ends_passive),
            stop_code=jnp.where(
                stop_now, jnp.where(joined, 4, -4), c.stop_code),
            done=c.done | stop_now,
        )

        # a new doubling will be attempted (WALNUTS.py:640-648)
        cont = go & ~stop_now
        pw = jnp.left_shift(jnp.ones((), jnp.int32), depth_t)
        c = c._replace(
            w_old_sum=jnp.where(cont, c.w_old_sum + c.w_new_sum, c.w_old_sum),
            b_abs=jnp.where(cont & fwd, c.b_abs + pw, c.b_abs),
            a_abs=jnp.where(cont & ~fwd, c.a_abs - pw, c.a_abs),
            depth_done=jnp.where(last, False, c.depth_done),
        )
        return c._replace(t=t + 1)

    carry = jax.lax.while_loop(cond, body, carry)

    # ------------------------------------------------------------------
    # 24-column diagnostics row (contract of WALNUTS.py:670-693)
    either_passive = (carry.lwt_sum_b < log_zero_edge) | (
        carry.lwt_sum_f < log_zero_edge
    )
    nst = jnp.maximum(carry.n_states, 1).astype(dtype)
    diag = jnp.stack(
        [
            carry.sel_l.astype(dtype),
            carry.n_doubl_sampled.astype(dtype),
            carry.orbit_len,
            carry.orbit_len_sam,
            carry.max_f_int.astype(dtype),
            carry.max_b_int.astype(dtype),
            carry.neval_f.astype(dtype),
            carry.neval_b.astype(dtype),
            carry.if_min.astype(dtype),
            carry.if_max.astype(dtype),
            carry.lwt_min,
            carry.lwt_max,
            carry.both_ends_passive.astype(dtype),
            either_passive.astype(dtype),
            carry.n_if_neq_ib.astype(dtype) / nst,
            h_step,
            carry.n_if_zero.astype(dtype) / nst,
            carry.h_max - carry.h_min,
            delta,
            carry.stop_code.astype(dtype),
            carry.n_doubl_computed.astype(dtype),
            carry.c_min.astype(dtype),
            carry.c_max.astype(dtype),
            carry.index_stat,
        ],
        axis=-1,
    )

    return TransitionResult(
        q=carry.q_prop,
        lp=carry.lp_prop,
        g=carry.g_prop,
        diagnostics=diag,
        p2=carry.p2,
        orbit_min=carry.orbit_min,
        orbit_max=carry.orbit_max,
    )
