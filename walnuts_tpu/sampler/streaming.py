"""Streaming (continuous-batching) WALNUTS driver — the batched
answer to per-chain orbit-depth divergence.

The scan driver (:mod:`.driver`) synchronises the chain batch at every
transition: all chains wait for the deepest orbit before anyone starts
the next iteration.  On the funnel benchmark the mean orbit depth is
~3 against a batch max of ~6.3 per iteration, so most of the batch's
micro steps are masked idle.

Here the transition loop is *flattened across iterations*, LLM-serving
style: every chain carries its own schedule position ``t`` and
iteration counter; the single persistent ``lax.while_loop`` advances
every chain by one orbit step each round, and a chain that finishes a
transition records its sample + 24-column diagnostics row (scatter
with OOB-drop indexing) and immediately begins its next orbit.  No
chain ever idles at a barrier; the loop ends when every chain has
completed ``num_iter`` transitions (only the final tail pays partial
utilisation).

Semantics are identical to :func:`walnuts_transition` per chain —
same integrators, same stop codes, same diagnostics contract — with
two documented differences:

* tuning is **fixed** during a streaming run (do warmup with the scan
  driver, then stream the sampling phase; ``bench.py`` does exactly
  this);
* randomness defaults to ``rng="hash"``: every draw is keyed by
  (seed, global chain id, the chain's own transition + schedule-row
  counters, purpose) with the same splitmix32 counter hash as the
  fused megakernel — one RNG semantics across the fast engines,
  per-chain reproducible regardless of batch size or
  composition.  ``rng="global"`` keeps the legacy loop-counter
  threefry keying (a chain's path then depends on the whole batch's
  progress).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..ops.integrators import get_integrator
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from .plans import build_schedule
from .transition import WalnutsConfig

_BIG_I32 = 2 ** 30          # plain int: no device array at import


class _SState(NamedTuple):
    n: jnp.ndarray            # scalar loop counter (keys randomness)
    t: jnp.ndarray            # [C] per-chain schedule position
    it: jnp.ndarray           # [C] per-chain completed transitions
    # orbit endpoint states
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
    # current chain position (start of the next transition)
    qc: jnp.ndarray
    lpc: jnp.ndarray
    gc: jnp.ndarray
    # proposal + depth snapshot
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
    xi_all: jnp.ndarray       # [C, m] direction signs of current orbit
    # control
    depth_done: jnp.ndarray
    stop_code: jnp.ndarray
    both_ends_passive: jnp.ndarray
    n_doubl_sampled: jnp.ndarray
    n_doubl_computed: jnp.ndarray
    max_f_int: jnp.ndarray
    max_b_int: jnp.ndarray
    # aggregates
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
    # checkpoint slab
    slab_q: jnp.ndarray       # [C, S, D]
    slab_v: jnp.ndarray
    # outputs
    samples: jnp.ndarray      # [num_iter, C, dg]
    diags: jnp.ndarray        # [num_iter, C, 24]


def _mmin(cur, new, m):
    return jnp.where(m, jnp.minimum(cur, new), cur)


def _mmax(cur, new, m):
    return jnp.where(m, jnp.maximum(cur, new), cur)


@partial(jax.jit, static_argnames=("target", "cfg", "num_iter", "rng"))
def run_walnuts_streaming(key, q0, h_step, delta, *, target,
                          cfg: WalnutsConfig, num_iter: int,
                          rng: str = "hash"):
    """Stream ``num_iter`` fixed-tuning WALNUTS transitions per chain.

    Args:
        key: PRNG key.
        q0: ``[C, D]`` initial positions.
        h_step, delta: per-chain tuning ``[C]`` (fixed for the run).
        target, cfg: as for :func:`walnuts_transition`.
        rng: ``"hash"`` (default) keys every draw by (seed, global
            chain id, the chain's OWN transition counter ``it`` and
            schedule row ``t``, purpose) via the same splitmix32
            counter hash the fused megakernel uses — a
            chain's stream is reproducible regardless of batch size
            or composition.  ``"global"`` keeps the legacy
            loop-counter threefry keying (a chain's draws then depend
            on the whole batch's progress).

    Returns ``(samples [num_iter, C, dg], diagnostics
    [num_iter, C, 24], q_final [C, D])``.  The output buffers ride the
    loop carry, so long runs should be chunked (restarting from
    ``q_final`` is exact — every transition begins with a momentum
    refresh anyway).
    """
    C, D = q0.shape
    dtype = q0.dtype
    m = cfg.m
    if not 1 <= m <= 32:
        # direction draws come from one uint32 bitmask per transition
        # (bits >> arange(m)); m > 32 would shift out of range and
        # produce silently biased doubling directions
        raise ValueError(f"cfg.m must be in [1, 32], got {m}")
    sched = build_schedule(m)
    T = sched.n_steps
    S = sched.capacity
    integrator = get_integrator(cfg.integrator)
    dg = target.generated_dim

    tab = {
        name: jnp.asarray(getattr(sched, name))
        for name in ("depth", "rel1", "rel2", "slot1", "slot2",
                     "last_of_depth", "is_depth0")
    }
    # every merge check's right endpoint is the row's just-integrated
    # rel2 state (verified property of the subtree plan), so the only
    # slab reads are the span-start slots — encode them as a [T, S]
    # mask and fuse ALL of a row's checks into one [C, S, D] reduction
    import numpy as _np0

    _check = _np0.zeros((T, S), bool)
    for _t in range(T):
        for _k in range(sched.max_post):
            if sched.post_valid[_t, _k]:
                _check[_t, sched.post_slot_lo[_t, _k]] = True
    check_slots = jnp.asarray(_check)
    # rel1 states are span starts worth storing only when rel1 == 1
    # (mod 4) at depths >= 2; rel2 (even) is never read back
    store1_tab = jnp.asarray(
        (sched.rel1 % 4 == 1) & (sched.depth >= 2))
    first_of_depth = jnp.asarray(
        [True] + [bool(sched.depth[i] != sched.depth[i - 1])
                  for i in range(1, T)])
    # index of the current depth's final row — a chain whose suborbit
    # already U-turned jumps straight to the depth-end resolution
    import numpy as _np

    _last_idx = _np.zeros(T, _np.int32)
    for _d in range(m):
        _rows = _np.where(sched.depth == _d)[0]
        _last_idx[_rows] = _rows[-1]
    last_idx_of_depth = jnp.asarray(_last_idx)

    lp0, g0 = target.logp_grad(q0)

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    zb = jnp.zeros((C,), bool)
    inf = jnp.asarray(jnp.inf, dtype)
    thresh = jnp.asarray(WT_SUM_THRESH, dtype)
    log_zero_edge = LOG_ZERO + 1.0

    st = _SState(
        n=jnp.zeros((), jnp.int32),
        t=zi, it=zi,
        qp=q0, vp=jnp.zeros_like(q0), gp=g0, lpp=lp0, hp=zf,
        qm=q0, vm=jnp.zeros_like(q0), gm=g0, lpm=lp0, hm=zf,
        qc=q0, lpc=lp0, gc=g0,
        q_prop=q0, lp_prop=lp0, g_prop=g0,
        q_prop_last=q0, lp_prop_last=lp0, g_prop_last=g0,
        mscale=zf, lwt_sum_f=zf, lwt_sum_b=zf,
        w_new_sum=zf, w_old_sum=jnp.ones((C,), dtype),
        sel_l=zi, sel_l_old=zi,
        idx_time=zf, index_stat=zf, index_stat_old=zf,
        time_f=zf, time_b=zf, orbit_len=zf, orbit_len_sam=zf,
        a_abs=zi, b_abs=zi,
        xi_all=jnp.ones((C, m), dtype),
        depth_done=zb, stop_code=zi, both_ends_passive=zb,
        n_doubl_sampled=zi, n_doubl_computed=zi,
        max_f_int=zi, max_b_int=zi,
        neval_f=zi, neval_b=zi,
        h_min=zf, h_max=zf,
        if_min=jnp.full((C,), _BIG_I32, jnp.int32), if_max=jnp.full((C,), -_BIG_I32, jnp.int32),
        c_min=jnp.full((C,), _BIG_I32, jnp.int32), c_max=jnp.full((C,), -_BIG_I32, jnp.int32),
        lwt_min=jnp.full((C,), inf), lwt_max=jnp.full((C,), -inf),
        n_states=zi, n_if_neq_ib=zi, n_if_zero=zi,
        slab_q=jnp.zeros((C, S, D), dtype),
        slab_v=jnp.zeros((C, S, D), dtype),
        samples=jnp.zeros((num_iter, C, dg), dtype),
        diags=jnp.zeros((num_iter, C, 24), dtype),
    )

    def _integrate(st, key_i, key_cat, hloc, xi, fwd, rel, slot, active,
                   is_d0, store):
        q_end = jnp.where(fwd[:, None], st.qp, st.qm)
        v_end = jnp.where(fwd[:, None], st.vp, st.vm)
        g_end = jnp.where(fwd[:, None], st.gp, st.gm)
        lp_end = jnp.where(fwd, st.lpp, st.lpm)
        h_end = jnp.where(fwd, st.hp, st.hm)

        res = integrator(key_i, target, q_end, v_end, g_end, lp_end,
                         h_end, hloc, xi, delta, None, active, cfg.igr)
        finite = jnp.isfinite(res.h_end)
        ok = active & finite

        af, ab = active & fwd, active & ~fwd
        abs_id = jnp.where(fwd, st.b_abs + rel, st.a_abs - rel)

        lwt_sum_f = st.lwt_sum_f + jnp.where(ok & fwd, res.lwt, 0.0)
        lwt_sum_b = st.lwt_sum_b + jnp.where(ok & ~fwd, res.lwt, 0.0)
        lwt_dir = jnp.where(fwd, lwt_sum_f, lwt_sum_b)
        w_new = jnp.exp(-res.h_end + st.mscale + lwt_dir)
        w_new_sum = st.w_new_sum + jnp.where(ok, w_new, 0.0)

        # key_cat is a pre-drawn uniform in rng="hash" mode
        if (isinstance(key_cat, jnp.ndarray)
                and jnp.issubdtype(key_cat.dtype, jnp.floating)):
            u = key_cat
        else:
            u = jax.random.uniform(key_cat, (C,), dtype)
        sel = ok & (w_new_sum > thresh) & (u * w_new_sum < w_new) & ~is_d0
        sel = sel | (ok & is_d0)
        signed_time_f = st.time_f + jnp.where(af, hloc, 0.0)
        signed_time_b = st.time_b + jnp.where(ab, hloc, 0.0)
        signed_time = jnp.where(fwd, signed_time_f, -signed_time_b)
        olen_mask = jnp.where(is_d0, active, ok)

        sel1 = sel[:, None]
        st = st._replace(
            qp=jnp.where(af[:, None], res.q, st.qp),
            vp=jnp.where(af[:, None], res.v, st.vp),
            gp=jnp.where(af[:, None], res.g, st.gp),
            lpp=jnp.where(af, res.lp, st.lpp),
            hp=jnp.where(af, res.h_end, st.hp),
            qm=jnp.where(ab[:, None], res.q, st.qm),
            vm=jnp.where(ab[:, None], res.v, st.vm),
            gm=jnp.where(ab[:, None], res.g, st.gm),
            lpm=jnp.where(ab, res.lp, st.lpm),
            hm=jnp.where(ab, res.h_end, st.hm),
            neval_f=st.neval_f + jnp.where(active, res.n_eval_f, 0),
            neval_b=st.neval_b + jnp.where(active, res.n_eval_b, 0),
            h_min=_mmin(st.h_min, res.h_end, active),
            h_max=_mmax(st.h_max, res.h_end, active),
            if_min=_mmin(st.if_min, res.i_f, active),
            if_max=_mmax(st.if_max, res.i_f, active),
            c_min=_mmin(st.c_min, res.c, active),
            c_max=_mmax(st.c_max, res.c, active),
            lwt_min=_mmin(st.lwt_min, res.lwt, active),
            lwt_max=_mmax(st.lwt_max, res.lwt, active),
            n_states=st.n_states + active.astype(jnp.int32),
            n_if_neq_ib=st.n_if_neq_ib
            + (active & (res.i_f != res.i_b)).astype(jnp.int32),
            n_if_zero=st.n_if_zero
            + (active & (res.i_f == 0)).astype(jnp.int32),
            max_f_int=jnp.where(af, abs_id, st.max_f_int),
            max_b_int=jnp.where(ab, abs_id, st.max_b_int),
            time_f=signed_time_f,
            time_b=signed_time_b,
            lwt_sum_f=lwt_sum_f,
            lwt_sum_b=lwt_sum_b,
            w_new_sum=w_new_sum,
            q_prop=jnp.where(sel1, res.q, st.q_prop),
            lp_prop=jnp.where(sel, res.lp, st.lp_prop),
            g_prop=jnp.where(sel1, res.g, st.g_prop),
            sel_l=jnp.where(sel, abs_id, st.sel_l),
            idx_time=jnp.where(sel, signed_time, st.idx_time),
            orbit_len=st.orbit_len + jnp.where(olen_mask, hloc, 0.0),
            # per-chain slot writes as a one-hot masked select: S
            # elementwise [C, D] ops instead of a general scatter.  ``store`` statically masks states
            # that are never read back (only span-start ids, which are
            # odd and == 1 mod 4, feed later merge checks).
            slab_q=jnp.where(
                ((ok & store)[:, None]
                 & (jnp.arange(S)[None, :] == slot[:, None]))[:, :, None],
                res.q[:, None, :], st.slab_q),
            slab_v=jnp.where(
                ((ok & store)[:, None]
                 & (jnp.arange(S)[None, :] == slot[:, None]))[:, :, None],
                res.v[:, None, :], st.slab_v),
        )
        return st, (res.q, res.v), finite, ok

    def cond(st):
        return jnp.any(st.it < num_iter)

    if rng == "hash":
        # identical seed/purpose derivation family to the megakernel
        # hash engine (megakernel.make_hash_draw), keyed by the
        # chain's OWN (it, t) counters instead of the global round
        from .megakernel import (_HASH_M1, _HASH_M2, _HASH_M3, _U_OFF,
                                 _U_SC, _TWO_PI, _mix32)

        seed = jax.random.randint(jax.random.fold_in(key, 777),
                                  (1,), 0, 2 ** 30, jnp.int32)[0]
        cid = jax.lax.broadcasted_iota(jnp.uint32, (1, C), 1)[0]
        lane = jax.lax.broadcasted_iota(jnp.uint32, (1, D), 1)
        h_c = _mix32(jnp.broadcast_to(seed, (C,)).astype(jnp.uint32)
                     + cid * jnp.uint32(_HASH_M1))

        def _to_f(x):
            return (x >> 8).astype(dtype)

        def hash_draws(it, t):
            """9 per-row draws keyed by (seed, cid, it, t, purpose)."""
            h_it = _mix32(h_c + it.astype(jnp.uint32)
                          * jnp.uint32(_HASH_M2))
            h_r = _mix32(h_it + t.astype(jnp.uint32)
                         * jnp.uint32(_HASH_M1))

            def u(p):
                return _to_f(_mix32(
                    h_r + jnp.uint32(p) * jnp.uint32(_HASH_M3))) * _U_SC

            b1 = _mix32(h_r[:, None]
                        + jnp.uint32(8) * jnp.uint32(_HASH_M3)
                        + lane * jnp.uint32(_HASH_M1))
            b2 = _mix32(h_r[:, None]
                        + jnp.uint32(9) * jnp.uint32(_HASH_M3)
                        + lane * jnp.uint32(_HASH_M1))
            u1 = _to_f(b1) * _U_SC + _U_OFF
            u2 = _to_f(b2) * _U_SC
            mom = (jnp.sqrt(-2.0 * jnp.log(u1))
                   * jnp.cos(_TWO_PI * u2)).astype(dtype)
            return dict(
                h1=u(0), h2=u(1), i1=u(2), i2=u(3), c1=u(4), c2=u(5),
                acc=u(6),
                dirs=_mix32(h_r + jnp.uint32(7) * jnp.uint32(_HASH_M3)),
                mom=mom)

    def body(st):
        n = st.n
        live = st.it < num_iter
        if rng == "hash":
            rr = hash_draws(st.it, st.t)
            k_i1, k_i2 = rr["i1"], rr["i2"]
            k_c1, k_c2 = rr["c1"], rr["c2"]
        else:
            kn = jax.random.fold_in(key, n)
            (k_h, k_i1, k_i2, k_c1, k_c2, k_acc, k_mom, k_dirs) = \
                jax.random.split(kn, 8)

        # ---- fresh-transition initialisation (t == 0) ----------------
        fresh = live & (st.t == 0)
        if rng == "hash":
            v0 = rr["mom"]
            bits = (rr["dirs"][:, None]
                    >> jnp.arange(m, dtype=jnp.uint32)[None, :]) & 1
            xi_new = jnp.where(bits != 0, 1.0, -1.0).astype(dtype)
        else:
            v0 = refresh_momentum(k_mom, (C, D), None, dtype)
            xi_new = jnp.where(
                jax.random.bernoulli(k_dirs, 0.5, (C, m)), 1.0, -1.0
            ).astype(dtype)
        h0 = hamiltonian(st.lpc, v0)
        f1 = fresh[:, None]
        st = st._replace(
            qp=jnp.where(f1, st.qc, st.qp), vp=jnp.where(f1, v0, st.vp),
            gp=jnp.where(f1, st.gc, st.gp),
            lpp=jnp.where(fresh, st.lpc, st.lpp),
            hp=jnp.where(fresh, h0, st.hp),
            qm=jnp.where(f1, st.qc, st.qm), vm=jnp.where(f1, v0, st.vm),
            gm=jnp.where(f1, st.gc, st.gm),
            lpm=jnp.where(fresh, st.lpc, st.lpm),
            hm=jnp.where(fresh, h0, st.hm),
            q_prop=jnp.where(f1, st.qc, st.q_prop),
            lp_prop=jnp.where(fresh, st.lpc, st.lp_prop),
            g_prop=jnp.where(f1, st.gc, st.g_prop),
            q_prop_last=jnp.where(f1, st.qc, st.q_prop_last),
            lp_prop_last=jnp.where(fresh, st.lpc, st.lp_prop_last),
            g_prop_last=jnp.where(f1, st.gc, st.g_prop_last),
            mscale=jnp.where(fresh, h0, st.mscale),
            lwt_sum_f=jnp.where(fresh, 0.0, st.lwt_sum_f),
            lwt_sum_b=jnp.where(fresh, 0.0, st.lwt_sum_b),
            w_new_sum=jnp.where(fresh, 0.0, st.w_new_sum),
            w_old_sum=jnp.where(fresh, 1.0, st.w_old_sum),
            sel_l=jnp.where(fresh, 0, st.sel_l),
            sel_l_old=jnp.where(fresh, 0, st.sel_l_old),
            idx_time=jnp.where(fresh, 0.0, st.idx_time),
            index_stat=jnp.where(fresh, 0.0, st.index_stat),
            index_stat_old=jnp.where(fresh, 0.0, st.index_stat_old),
            time_f=jnp.where(fresh, 0.0, st.time_f),
            time_b=jnp.where(fresh, 0.0, st.time_b),
            orbit_len=jnp.where(fresh, 0.0, st.orbit_len),
            orbit_len_sam=jnp.where(fresh, 0.0, st.orbit_len_sam),
            a_abs=jnp.where(fresh, 0, st.a_abs),
            b_abs=jnp.where(fresh, 0, st.b_abs),
            xi_all=jnp.where(f1, xi_new, st.xi_all),
            depth_done=jnp.where(fresh, False, st.depth_done),
            stop_code=jnp.where(fresh, 0, st.stop_code),
            both_ends_passive=jnp.where(fresh, False,
                                        st.both_ends_passive),
            n_doubl_sampled=jnp.where(fresh, 0, st.n_doubl_sampled),
            n_doubl_computed=jnp.where(fresh, 0, st.n_doubl_computed),
            max_f_int=jnp.where(fresh, 0, st.max_f_int),
            max_b_int=jnp.where(fresh, 0, st.max_b_int),
            neval_f=jnp.where(fresh, 0, st.neval_f),
            neval_b=jnp.where(fresh, 0, st.neval_b),
            h_min=jnp.where(fresh, h0, st.h_min),
            h_max=jnp.where(fresh, h0, st.h_max),
            if_min=jnp.where(fresh, jnp.int32(_BIG_I32), st.if_min),
            if_max=jnp.where(fresh, jnp.int32(-_BIG_I32), st.if_max),
            c_min=jnp.where(fresh, jnp.int32(_BIG_I32), st.c_min),
            c_max=jnp.where(fresh, jnp.int32(-_BIG_I32), st.c_max),
            lwt_min=jnp.where(fresh, inf, st.lwt_min),
            lwt_max=jnp.where(fresh, -inf, st.lwt_max),
            n_states=jnp.where(fresh, 0, st.n_states),
            n_if_neq_ib=jnp.where(fresh, 0, st.n_if_neq_ib),
            n_if_zero=jnp.where(fresh, 0, st.n_if_zero),
        )

        # ---- per-chain schedule row ---------------------------------
        t = st.t
        depth_t = tab["depth"][t]
        rel1 = tab["rel1"][t]
        rel2 = tab["rel2"][t]
        slot1 = tab["slot1"][t]
        slot2 = tab["slot2"][t]
        last = tab["last_of_depth"][t]
        is_d0 = tab["is_depth0"][t]
        first = first_of_depth[t]

        xi = jnp.take_along_axis(st.xi_all, depth_t[:, None], 1)[:, 0]
        fwd = xi > 0

        s = cfg.step_size_rand_scale
        if rng == "hash":
            hloc = h_step[:, None] * (
                (1.0 - s) + jnp.stack([rr["h1"], rr["h2"]], 1)
                * (2.0 * s))
        else:
            hloc = h_step[:, None] * jax.random.uniform(
                k_h, (C, 2), dtype, 1.0 - s, 1.0 + s)

        # depth-start snapshot
        snap = live & first & ~is_d0
        st = st._replace(
            q_prop_last=jnp.where(snap[:, None], st.q_prop,
                                  st.q_prop_last),
            lp_prop_last=jnp.where(snap, st.lp_prop, st.lp_prop_last),
            g_prop_last=jnp.where(snap[:, None], st.g_prop,
                                  st.g_prop_last),
            sel_l_old=jnp.where(snap, st.sel_l, st.sel_l_old),
            index_stat_old=jnp.where(snap, st.index_stat,
                                     st.index_stat_old),
            w_new_sum=jnp.where(snap | (live & first & is_d0), 0.0,
                                st.w_new_sum),
        )

        alive = live & ~st.depth_done

        st, (q1, v1), finite1, ok1 = _integrate(
            st, k_i1, k_c1, hloc[:, 0], xi, fwd, rel1, slot1, alive,
            is_d0, store1_tab[t])
        forced1 = alive & ~finite1
        act2 = ok1 & ~is_d0
        st, (q2, v2), finite2, ok2 = _integrate(
            st, k_i2, k_c2, hloc[:, 1], xi, fwd, rel2, slot2, act2,
            jnp.zeros((C,), bool), jnp.zeros((C,), bool))
        forced2 = act2 & ~finite2
        forced = forced1 | forced2

        # adjacent U-turn
        eq = jnp.where(fwd[:, None], q1, q2)
        ev = jnp.where(fwd[:, None], v1, v2)
        lq = jnp.where(fwd[:, None], q2, q1)
        lv = jnp.where(fwd[:, None], v2, v1)
        adj_ut = uturn(eq, ev, lq, lv)
        depth_done = st.depth_done | (ok2 & adj_ut)

        # merge checks: all of this row's span-start slots against the
        # just-integrated state (q2, v2), fused into one [C, S, D]
        # reduction.  With d_f = q2 - slab_q, the time orientation only
        # flips the inequality signs.
        ar = jnp.arange(C)
        lvl_mask = check_slots[t]                      # [C, S]
        d_f = q2[:, None, :] - st.slab_q               # [C, S, D]
        dot_new = jnp.sum(v2[:, None, :] * d_f, axis=-1)   # [C, S]
        dot_old = jnp.sum(st.slab_v * d_f, axis=-1)        # [C, S]
        ut_all = jnp.where(fwd[:, None],
                           (dot_new < 0.0) | (dot_old < 0.0),
                           (dot_new > 0.0) | (dot_old > 0.0))
        merge_ut = jnp.any(lvl_mask & ut_all, axis=1)
        depth_done = depth_done | (ok2 & merge_ut)

        done = forced
        st = st._replace(
            depth_done=depth_done,
            stop_code=jnp.where(forced, 999, st.stop_code),
        )

        # depth-end resolution
        p_mask = live & last & ~done
        su = p_mask & st.depth_done
        go = p_mask & ~st.depth_done

        u_acc = (rr["acc"] if rng == "hash"
                 else jax.random.uniform(k_acc, (C,), dtype))
        keep_new = u_acc * st.w_old_sum < st.w_new_sum
        restore = su | (go & ~keep_new)
        st = st._replace(
            q_prop=jnp.where(restore[:, None], st.q_prop_last,
                             st.q_prop),
            lp_prop=jnp.where(restore, st.lp_prop_last, st.lp_prop),
            g_prop=jnp.where(restore[:, None], st.g_prop_last,
                             st.g_prop),
            sel_l=jnp.where(restore, st.sel_l_old, st.sel_l),
            index_stat=jnp.where(
                restore, st.index_stat_old,
                jnp.where(p_mask,
                          st.idx_time / (st.time_f + st.time_b),
                          st.index_stat)),
        )

        st = st._replace(
            n_doubl_sampled=jnp.where(su, depth_t, st.n_doubl_sampled),
            n_doubl_computed=jnp.where(su, depth_t + 1,
                                       st.n_doubl_computed),
            stop_code=jnp.where(su, 5, st.stop_code),
        )
        done = done | su

        joined = uturn(st.qm, st.vm, st.qp, st.vp)
        passive = (st.lwt_sum_b < log_zero_edge) & (
            st.lwt_sum_f < log_zero_edge)
        stop_now = go & (joined | passive)
        st = st._replace(
            n_doubl_sampled=jnp.where(go, depth_t + 1,
                                      st.n_doubl_sampled),
            n_doubl_computed=jnp.where(go, depth_t + 1,
                                       st.n_doubl_computed),
            orbit_len_sam=jnp.where(go, st.orbit_len, st.orbit_len_sam),
            both_ends_passive=jnp.where(go, passive,
                                        st.both_ends_passive),
            stop_code=jnp.where(stop_now, jnp.where(joined, 4, -4),
                                st.stop_code),
        )
        done = done | stop_now

        cont = go & ~stop_now
        pw = jnp.left_shift(jnp.ones((), jnp.int32), depth_t)
        exhausted = cont & (st.t + 1 >= T)
        done = done | exhausted
        st = st._replace(
            w_old_sum=jnp.where(cont, st.w_old_sum + st.w_new_sum,
                                st.w_old_sum),
            b_abs=jnp.where(cont & fwd, st.b_abs + pw, st.b_abs),
            a_abs=jnp.where(cont & ~fwd, st.a_abs - pw, st.a_abs),
            depth_done=jnp.where(last, False, st.depth_done),
        )
        done = done & live

        # ---- finalise completed transitions -------------------------
        either_passive = (st.lwt_sum_b < log_zero_edge) | (
            st.lwt_sum_f < log_zero_edge)
        nst = jnp.maximum(st.n_states, 1).astype(dtype)
        diag_row = jnp.stack([
            st.sel_l.astype(dtype),
            st.n_doubl_sampled.astype(dtype),
            st.orbit_len, st.orbit_len_sam,
            st.max_f_int.astype(dtype), st.max_b_int.astype(dtype),
            st.neval_f.astype(dtype), st.neval_b.astype(dtype),
            st.if_min.astype(dtype), st.if_max.astype(dtype),
            st.lwt_min, st.lwt_max,
            st.both_ends_passive.astype(dtype),
            either_passive.astype(dtype),
            st.n_if_neq_ib.astype(dtype) / nst,
            h_step,
            st.n_if_zero.astype(dtype) / nst,
            st.h_max - st.h_min,
            delta,
            st.stop_code.astype(dtype),
            st.n_doubl_computed.astype(dtype),
            st.c_min.astype(dtype), st.c_max.astype(dtype),
            st.index_stat,
        ], axis=-1)

        # scatter rows for chains finishing now; everyone else gets an
        # out-of-bounds row index and is dropped
        row = jnp.where(done, st.it, num_iter)
        gen = target.generated(st.q_prop)
        samples = st.samples.at[row, ar].set(gen, mode="drop")
        diags = st.diags.at[row, ar].set(diag_row, mode="drop")

        # advance: finished chains restart at t=0 from the proposal;
        # depth-done chains skip to their depth's resolution row
        d1 = done[:, None]
        t_next = jnp.where(st.depth_done & ~last,
                           last_idx_of_depth[st.t], st.t + 1)
        st = st._replace(
            n=n + 1,
            t=jnp.where(done | ~live, 0, t_next),
            it=st.it + done.astype(jnp.int32),
            qc=jnp.where(d1, st.q_prop, st.qc),
            lpc=jnp.where(done, st.lp_prop, st.lpc),
            gc=jnp.where(d1, st.g_prop, st.gc),
            samples=samples,
            diags=diags,
        )
        return st

    st = jax.lax.while_loop(cond, body, st)
    return st.samples, st.diags, st.qc
