"""Fully-flattened WALNUTS driver: one batched leapfrog micro step per
loop round for every chain ("megakernel" execution model).

Why: profiling the streaming driver at warmup-adapted funnel tuning
shows each *pair round* costs ~100-150 batched micro-step iterations
(the halving search runs every level-c trial for the whole batch while
a shrinking fraction of chains is active) but delivers only ~3 useful
gradient evaluations per chain — ~2% of the micro steps.  Here the
third and final level of control flow is flattened: per chain, a small state
machine tracks (phase, refinement level, micro-step index) of its
current integrator trial, and the single persistent loop advances
EVERY chain by exactly one micro leapfrog step each round.  A chain
that finishes a trial immediately starts its next one; a chain that
finishes a macro step runs the orbit bookkeeping in the same round and
starts the next macro step on the next round.  No chain ever waits for
another's refinement search, orbit depth, or transition boundary.

Phases of the per-chain integrator state machine (R2P protocol,
``adaptiveIntegrators.py:361-475``):

* ``FWD`` — forward halving trial at level ``c``: on completion test
  ``|H_end - H_0| < delta``; accept -> record ``If`` and either keep
  the trial (coarse draw, prob 2/3) and go ``BWD``, or reset for one
  refined trial at ``If + 1`` (``R2P`` phase); reject -> retry at
  ``c + 1`` (at ``max_c`` the trial is kept regardless).
* ``R2P`` — the refined two-point trial; its endpoint is always taken.
* ``BWD`` — backward halving trials from the flipped endpoint to find
  ``Ib``; on resolution the macro step completes with the Hastings
  weight ``log p(c_sim | Ib) - log p(c_sim | If)``.

Orbit-level semantics (selection, sub-U-turn plans, stop codes,
diagnostics) are identical to :mod:`.streaming` / :mod:`.transition`;
statistical equivalence is tested.  Tuning is either fixed or adapted
in-loop (``warmup=``: per-chain P2-based H/delta adaptation with
optional pooled consensus — one invocation covers warmup + sampling).
Randomness defaults to ``rng="hash"``: every draw is keyed by (seed,
global chain id, per-chain counters, purpose) via a splitmix32 counter
hash — per-chain reproducible across batch compositions.  ``rng="global"``
keeps the legacy round-counter threefry keying.

Round-cost design: the round issues no samples/diags ring-buffer
scatter (only ~1% of chains complete a transition per round) and no
[C]-index gather from static schedule tables:

* the orbit schedule is *computed arithmetically* from the row index
  ``t`` (``depth = 32 - clz(t)``, pair ids ``2j+1 / 2j+2``, power-of-2
  first/last tests, mod-2^j span store/check masks) — zero gathers;
  direction bits live in one ``uint32`` bitmask per chain instead of a
  ``[C, m]`` float table;
* completed transitions are staged into two dense ``[C, .]`` pending
  slots and the expensive scatter runs once every ``_FLUSH_EVERY``
  rounds under ``lax.cond`` (plus once after the loop).  A chain only
  stalls when both its slots are pending — requiring a free slot at
  transition *start* guarantees one at completion.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.hamiltonian import hamiltonian, refresh_momentum, uturn
from ..utils.constants import LOG_ZERO, WT_SUM_THRESH
from ..utils.p2 import P2State, p2_init, p2_push, p2_quantile
from .driver import WarmupConfig
from .transition import WalnutsConfig

_BIG_I32 = 2**30  # int32 sentinel that opens the running If / c extrema


def _slab_dtype(dtype):
    """Span-slab storage dtype: bf16 under f32 runs (see the state
    init comment), the run dtype otherwise."""
    return jnp.bfloat16 if dtype == jnp.float32 else dtype
FWD, R2P, BWD = 0, 1, 2
_FLUSH_EVERY = 16  # rounds between ring-buffer scatter flushes


class _MState(NamedTuple):
    n: jnp.ndarray
    t: jnp.ndarray
    it: jnp.ndarray
    # ---- integrator state machine ----
    phase: jnp.ndarray        # [C] FWD/R2P/BWD
    c_cur: jnp.ndarray        # [C] current trial level
    k: jnp.ndarray            # [C] micro step within trial
    second: jnp.ndarray       # [C] bool: integrating pair's 2nd state
    h_loc: jnp.ndarray        # [C] jittered macro step length
    coarse: jnp.ndarray       # [C] bool R2P coarse draw
    i_f: jnp.ndarray          # [C]
    # macro-step start state (trial restart point)
    qs: jnp.ndarray
    vs: jnp.ndarray
    gs: jnp.ndarray
    lps: jnp.ndarray
    h0s: jnp.ndarray
    # live trial state
    qt: jnp.ndarray
    vt: jnp.ndarray
    gt: jnp.ndarray
    lpt: jnp.ndarray
    ht: jnp.ndarray
    dht: jnp.ndarray          # running max |dH| of trial
    fint: jnp.ndarray         # [C] trial finite flag (f32 mask)
    # accepted forward state (the macro step's endpoint candidate)
    qa: jnp.ndarray
    va: jnp.ndarray
    ga: jnp.ndarray
    lpa: jnp.ndarray
    ha: jnp.ndarray
    dha: jnp.ndarray
    c_sim: jnp.ndarray
    nev_f: jnp.ndarray        # evals this macro step (fwd+fine)
    nev_b: jnp.ndarray
    # previous pair member (for the adjacent U-turn check)
    q1: jnp.ndarray
    v1: jnp.ndarray
    # ---- orbit state (as in streaming) ----
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
    qc: jnp.ndarray
    lpc: jnp.ndarray
    gc: jnp.ndarray
    q_prop: jnp.ndarray
    lp_prop: jnp.ndarray
    g_prop: jnp.ndarray
    q_prop_last: jnp.ndarray
    lp_prop_last: jnp.ndarray
    g_prop_last: jnp.ndarray
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
    xi_bits: jnp.ndarray      # [C] uint32: doubling-direction bitmask
    depth_done: jnp.ndarray
    stop_code: jnp.ndarray
    both_ends_passive: jnp.ndarray
    n_doubl_sampled: jnp.ndarray
    n_doubl_computed: jnp.ndarray
    max_f_int: jnp.ndarray
    max_b_int: jnp.ndarray
    neval_f: jnp.ndarray
    neval_b: jnp.ndarray
    h_min: jnp.ndarray
    h_max: jnp.ndarray
    if_min: jnp.ndarray
    if_max: jnp.ndarray
    c_min_d: jnp.ndarray
    c_max_d: jnp.ndarray
    lwt_min: jnp.ndarray
    lwt_max: jnp.ndarray
    n_states: jnp.ndarray
    n_if_neq_ib: jnp.ndarray
    n_if_zero: jnp.ndarray
    slab_q: jnp.ndarray
    slab_v: jnp.ndarray
    samples: jnp.ndarray
    diags: jnp.ndarray
    grad_ct: jnp.ndarray      # [C] per-chain gradient-eval count
    # staged transition outputs awaiting the periodic scatter flush
    pend0: jnp.ndarray        # [C] bool slot-0 occupied
    pend1: jnp.ndarray        # [C] bool slot-1 occupied
    prow0: jnp.ndarray        # [C] int32 destination row
    prow1: jnp.ndarray
    pgen0: jnp.ndarray        # [C, dg]
    pgen1: jnp.ndarray
    pdiag0: jnp.ndarray       # [24, C] (row-contiguous stack)
    pdiag1: jnp.ndarray
    # in-loop warmup adaptation (loop-invariant when warmup is off)
    h_cur: jnp.ndarray        # [C] current macro step size
    delta_cur: jnp.ndarray    # [C] current tolerance
    p2h: P2State              # per-chain log-igrConst quantile
    p2d: P2State              # per-chain energy-error-factor quantile



def _draw_round_rands(key, n, C, D, dtype):
    """The six per-round random draws, keyed by the global round
    counter with the former in-line draws' key derivation (the five
    uniform/normal draws are bitwise-identically keyed; the direction
    draw changed from a [C, m] bernoulli to one uint32 bits draw —
    distributionally equivalent, not bitwise)."""
    kn = jax.random.fold_in(key, n)
    (k_h, k_co, k_cat, k_acc, k_mom, k_dirs) = jax.random.split(kn, 6)
    return dict(
        h_u=jax.random.uniform(k_h, (C,), dtype),
        co_u=jax.random.uniform(k_co, (C,), dtype),
        cat_u=jax.random.uniform(k_cat, (C,), dtype),
        acc_u=jax.random.uniform(k_acc, (C,), dtype),
        mom=jax.random.normal(k_mom, (C, D), dtype),
        dirs=jax.random.bits(k_dirs, (C,), jnp.uint32),
    )


# ---------------------------------------------------------------------------
# per-chain counter-hash RNG
# ---------------------------------------------------------------------------

_HASH_M1 = 0x9E3779B9
_HASH_M2 = 0x85EBCA6B
_HASH_M3 = 0xC2B2AE35
_U_SC = 2.0 ** -24
_U_OFF = 2.0 ** -25
_TWO_PI = 6.283185307179586


def _mix32(x):
    """splitmix32 finalizer: full-avalanche bijection on uint32."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_hash_draw(seed_i32, cid, D, dtype):
    """Build ``draw(n_abs) -> rnd``: the six per-round draws from a
    splitmix32 counter hash keyed by (seed, GLOBAL chain id, absolute
    round, purpose[, coordinate]).

    A chain's stream depends only on its own (id, round) — never on
    batch size or composition — so a chain re-run alone or in a
    different batch replays identically.

    Args: ``seed_i32`` scalar int32 and ``n_abs`` non-negative, both
    below 2^31; ``cid`` uint32 ``[C]`` global chain ids; ``D`` the
    dimension; ``dtype`` of the float draws.
    """
    lane = jax.lax.broadcasted_iota(jnp.uint32, (1, D), 1)
    h_c = _mix32(seed_i32.astype(jnp.uint32) + cid * jnp.uint32(_HASH_M1))

    def _to_f(x):
        # top 24 bits -> float in [0, 1) after scaling; exact in f32
        return (x >> 8).astype(dtype)

    def draw(n_abs):
        h_r = _mix32(h_c + n_abs.astype(jnp.uint32) * jnp.uint32(_HASH_M2))

        def u(p):
            return _to_f(
                _mix32(h_r + jnp.uint32(p) * jnp.uint32(_HASH_M3))
            ) * _U_SC

        b1 = _mix32(h_r[:, None] + jnp.uint32(5) * jnp.uint32(_HASH_M3)
                    + lane * jnp.uint32(_HASH_M1))
        b2 = _mix32(h_r[:, None] + jnp.uint32(6) * jnp.uint32(_HASH_M3)
                    + lane * jnp.uint32(_HASH_M1))
        u1 = _to_f(b1) * _U_SC + _U_OFF
        u2 = _to_f(b2) * _U_SC
        mom = (jnp.sqrt(-2.0 * jnp.log(u1))
               * jnp.cos(_TWO_PI * u2)).astype(dtype)
        return dict(
            h_u=u(0), co_u=u(1), cat_u=u(2), acc_u=u(3),
            dirs=_mix32(h_r + jnp.uint32(4) * jnp.uint32(_HASH_M3)),
            mom=mom)

    return draw


def _make_round_body(*, target, cfg, warmup, stop_mode, num_iter, R,
                     C, D, dtype, micro_unroll=1, ablate=()):
    """Build the one-round state transition ``body(st, rnd) -> st``.

    ``ablate`` (PROFILING ONLY — breaks sampler semantics): skip
    named cost centres to measure their share of the round.
    ``"slab"`` drops the span-slab store + merge U-turn check;
    ``"stage"`` drops the diagnostics-row stack and the
    sample/diag staging writes.  Used by ``tools/profile_round.py``;
    never set in production paths.

    The round body is pure masked elementwise jnp over ``[C]`` /
    ``[C, D]`` state — no host control flow and no RNG (the caller
    supplies the six per-round draws in ``rnd``).
    """
    import numpy as np

    m = cfg.m
    min_c = cfg.igr.min_c
    max_c = cfg.igr.max_c
    p0 = cfg.igr.r2p_prob0
    # integrator protocol: the R2P state machine (FWD/R2P/BWD) also
    # runs the D-family deterministic protocol
    # (adaptiveIntegrators.py:65-137) as the degenerate case
    # coarse=True always (simulate at If, never a refined trial;
    # backward sweep capped at If-1 with default Ib=If) with the hard
    # reversibility weight lwt = logZero * [If != Ib].  With
    # min_c == max_c == 0 the D protocol reduces exactly to
    # fixed_leapfrog (adaptiveIntegrators.py:49-59): the single c=0
    # trial is kept regardless of the energy error, there are no
    # backward levels, and lwt == 0 — i.e. multinomial NUTS.
    proto_d = cfg.integrator in ("adapt_leapfrog_d", "fixed_leapfrog")
    if cfg.integrator == "fixed_leapfrog":
        min_c = max_c = 0
    # trace-time constants in the run dtype
    np_dtype = jnp.zeros((), dtype).dtype
    lp_c = np.log(np.asarray(p0, np_dtype))
    lp_f = np.log(np.asarray(1.0 - p0, np_dtype))
    T = 2 ** (m - 1)
    S = max(m - 2, 1)
    # span levels j = 2 .. S+1 serviced by the slab
    jlev = np.arange(2, S + 2, dtype=np.int32)[None, :]      # [1, S]
    pw_lev = np.left_shift(1, jlev)
    thresh = np.asarray(WT_SUM_THRESH, np_dtype)
    log_zero_edge = LOG_ZERO + 1.0
    inf = np.asarray(np.inf, np_dtype)

    def body(st, rnd):
        n = st.n
        if stop_mode in ("total", "min_per_chain"):
            live = jnp.ones((C,), bool)
        else:
            live = st.it < num_iter

        # ------------------------------------------------------------
        # A. fresh-transition init for chains flagged k == -1 & t == 0
        #    (a chain with both pending slots occupied stalls here
        #    until the next flush, so a completing transition is
        #    always guaranteed a free slot)
        # ------------------------------------------------------------
        needs_fresh = (st.k < 0) & (st.t == 0)
        stall = st.pend0 & st.pend1
        if stop_mode == "min_per_chain":
            # surplus chains (past quota) don't store, so never stall
            stall = stall & (st.it < num_iter)
        fresh = live & needs_fresh & ~stall
        v0 = rnd["mom"]
        h0f = hamiltonian(st.lpc, v0)
        xi_new = rnd["dirs"]
        f1 = fresh[:, None]
        st = st._replace(
            qp=jnp.where(f1, st.qc, st.qp), vp=jnp.where(f1, v0, st.vp),
            gp=jnp.where(f1, st.gc, st.gp),
            lpp=jnp.where(fresh, st.lpc, st.lpp),
            hp=jnp.where(fresh, h0f, st.hp),
            qm=jnp.where(f1, st.qc, st.qm), vm=jnp.where(f1, v0, st.vm),
            gm=jnp.where(f1, st.gc, st.gm),
            lpm=jnp.where(fresh, st.lpc, st.lpm),
            hm=jnp.where(fresh, h0f, st.hm),
            q_prop=jnp.where(f1, st.qc, st.q_prop),
            lp_prop=jnp.where(fresh, st.lpc, st.lp_prop),
            g_prop=jnp.where(f1, st.gc, st.g_prop),
            q_prop_last=jnp.where(f1, st.qc, st.q_prop_last),
            lp_prop_last=jnp.where(fresh, st.lpc, st.lp_prop_last),
            g_prop_last=jnp.where(f1, st.gc, st.g_prop_last),
            mscale=jnp.where(fresh, h0f, st.mscale),
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
            xi_bits=jnp.where(fresh, xi_new, st.xi_bits),
            depth_done=st.depth_done & ~fresh,
            stop_code=jnp.where(fresh, 0, st.stop_code),
            both_ends_passive=st.both_ends_passive & ~fresh,
            n_doubl_sampled=jnp.where(fresh, 0, st.n_doubl_sampled),
            n_doubl_computed=jnp.where(fresh, 0, st.n_doubl_computed),
            max_f_int=jnp.where(fresh, 0, st.max_f_int),
            max_b_int=jnp.where(fresh, 0, st.max_b_int),
            neval_f=jnp.where(fresh, 0, st.neval_f),
            neval_b=jnp.where(fresh, 0, st.neval_b),
            h_min=jnp.where(fresh, h0f, st.h_min),
            h_max=jnp.where(fresh, h0f, st.h_max),
            if_min=jnp.where(fresh, _BIG_I32, st.if_min),
            if_max=jnp.where(fresh, -_BIG_I32, st.if_max),
            c_min_d=jnp.where(fresh, _BIG_I32, st.c_min_d),
            c_max_d=jnp.where(fresh, -_BIG_I32, st.c_max_d),
            lwt_min=jnp.where(fresh, inf, st.lwt_min),
            lwt_max=jnp.where(fresh, -inf, st.lwt_max),
            n_states=jnp.where(fresh, 0, st.n_states),
            n_if_neq_ib=jnp.where(fresh, 0, st.n_if_neq_ib),
            n_if_zero=jnp.where(fresh, 0, st.n_if_zero),
            second=st.second & ~fresh,
        )

        # per-chain schedule row, in closed form (no gathers): depth d
        # occupies rows [2^(d-1), 2^d) so depth = 32 - clz(t), depth
        # starts are exactly the powers of two, and pair j of a depth
        # integrates relative states (2j+1, 2j+2)
        t = st.t
        depth_t = 32 - jax.lax.clz(t)
        is_d0 = t == 0
        pw_d = jnp.left_shift(1, depth_t)
        last = t == pw_d - 1
        first = (t & (t - 1)) == 0
        j_pair = t - jnp.left_shift(1, jnp.maximum(depth_t - 1, 0))
        rel1_t = jnp.where(is_d0, 1, 2 * j_pair + 1)
        rel2_t = jnp.where(is_d0, 0, 2 * j_pair + 2)
        fwd_dir = (jnp.right_shift(
            st.xi_bits, depth_t.astype(jnp.uint32)) & 1).astype(bool)

        # depth-start snapshot (once, on the row's first macro start)
        snap = (live & first & ~is_d0 & (st.k < 0) & ~st.second
                & ~st.depth_done)
        st = st._replace(
            q_prop_last=jnp.where(snap[:, None], st.q_prop,
                                  st.q_prop_last),
            lp_prop_last=jnp.where(snap, st.lp_prop, st.lp_prop_last),
            g_prop_last=jnp.where(snap[:, None], st.g_prop,
                                  st.g_prop_last),
            sel_l_old=jnp.where(snap, st.sel_l, st.sel_l_old),
            index_stat_old=jnp.where(snap, st.index_stat,
                                     st.index_stat_old),
            w_new_sum=jnp.where(snap, 0.0, st.w_new_sum),
        )

        # ------------------------------------------------------------
        # B. macro-step start: chains with k < 0 latch a jittered
        #    step, the coarse draw, and the trial start state
        # ------------------------------------------------------------
        idle = st.depth_done  # no integration while the suborbit is dead
        starting = live & (st.k < 0) & ~idle & ~(needs_fresh & stall)
        s_sc = cfg.step_size_rand_scale
        h_draw = st.h_cur * ((1.0 - s_sc)
                             + rnd["h_u"] * (2.0 * s_sc))
        # D protocol == R2P with the coarse branch forced (no refined
        # trial); the co_u draw is simply unused (draws are keyed by
        # purpose, not consumed sequentially, so streams stay aligned)
        co_draw = (jnp.ones((C,), bool) if proto_d
                   else rnd["co_u"] < p0)
        # integration starts from the travel-direction endpoint
        q_e = jnp.where(fwd_dir[:, None], st.qp, st.qm)
        v_e = jnp.where(fwd_dir[:, None], st.vp, -st.vm)
        g_e = jnp.where(fwd_dir[:, None], st.gp, st.gm)
        lp_e = jnp.where(fwd_dir, st.lpp, st.lpm)
        h_e = jnp.where(fwd_dir, st.hp, st.hm)
        s1c = starting[:, None]
        st = st._replace(
            h_loc=jnp.where(starting, h_draw, st.h_loc),
            coarse=jnp.where(starting, co_draw, st.coarse),
            phase=jnp.where(starting, FWD, st.phase),
            c_cur=jnp.where(starting, min_c, st.c_cur),
            k=jnp.where(starting, 0, st.k),
            qs=jnp.where(s1c, q_e, st.qs),
            vs=jnp.where(s1c, v_e, st.vs),
            gs=jnp.where(s1c, g_e, st.gs),
            lps=jnp.where(starting, lp_e, st.lps),
            h0s=jnp.where(starting, h_e, st.h0s),
            qt=jnp.where(s1c, q_e, st.qt),
            vt=jnp.where(s1c, v_e, st.vt),
            gt=jnp.where(s1c, g_e, st.gt),
            lpt=jnp.where(starting, lp_e, st.lpt),
            ht=jnp.where(starting, h_e, st.ht),
            dht=jnp.where(starting, 0.0, st.dht),
            fint=jnp.where(starting, 1.0, st.fint),
            nev_f=jnp.where(starting, 0, st.nev_f),
            nev_b=jnp.where(starting, 0, st.nev_b),
            i_f=jnp.where(starting, max_c, st.i_f),
        )

        # ------------------------------------------------------------
        # C. batched leapfrog micro steps for every integrating chain.
        #    With micro_unroll = K > 1 the round advances up to K
        #    micro steps back-to-back: only the 7 live-trial arrays
        #    are rewritten per sub-step, so the ~35 bookkeeping
        #    carries (sections A/B/D-G) amortise over K gradient
        #    evaluations instead of 1.  A chain whose trial boundary
        #    falls mid-round masks out of the remaining sub-steps
        #    (bounded idle: < K-1 steps per trial) and resolves its
        #    completion in section D as usual.
        # ------------------------------------------------------------
        n_steps_cur = jnp.left_shift(1, st.c_cur)
        base = live & (st.k >= 0) & ~idle
        for _sub in range(micro_unroll):
            # sub-step 0's k < n_steps guard is a no-op by invariant
            # (completions reset k before the next round) but keeps
            # every sub-step identical
            integ = base & (st.k < n_steps_cur)
            hh = jnp.where(integ, st.h_loc / n_steps_cur.astype(dtype),
                           0.0)
            hh1 = hh[:, None]
            vh = st.vt + 0.5 * hh1 * st.gt
            q2 = st.qt + hh1 * vh
            lp2, g2 = target.logp_grad(q2)
            v2 = vh + 0.5 * hh1 * g2
            h2 = -lp2 + 0.5 * jnp.sum(v2 * v2, axis=-1)
            i1 = integ[:, None]
            dh2 = jnp.abs(h2 - st.ht)
            st = st._replace(
                qt=jnp.where(i1, q2, st.qt),
                vt=jnp.where(i1, v2, st.vt),
                gt=jnp.where(i1, g2, st.gt),
                lpt=jnp.where(integ, lp2, st.lpt),
                ht=jnp.where(integ, h2, st.ht),
                dht=jnp.where(integ, jnp.maximum(st.dht, dh2), st.dht),
                fint=jnp.where(integ & ~jnp.isfinite(h2), 0.0, st.fint),
                k=jnp.where(integ, st.k + 1, st.k),
                nev_f=st.nev_f
                + (integ & (st.phase != BWD)).astype(jnp.int32),
                nev_b=st.nev_b
                + (integ & (st.phase == BWD)).astype(jnp.int32),
                grad_ct=st.grad_ct + integ.astype(jnp.int32),
            )

        # ------------------------------------------------------------
        # D. trial completion
        # ------------------------------------------------------------
        # `base`, not the last sub-step's `integ`: with micro_unroll a
        # chain that hits its trial boundary mid-round is masked out
        # of later sub-steps but must still resolve its completion
        t_done = base & (st.k >= n_steps_cur)
        t_fin = st.fint > 0.5
        err_ok = t_fin & (jnp.abs(st.h0s - st.ht) < st.delta_cur)

        # -- FWD completions
        f_done = t_done & (st.phase == FWD)
        f_acc = f_done & (err_ok | (st.c_cur == max_c))
        # accept the trial as the forward state
        a1 = f_acc[:, None]
        st = st._replace(
            i_f=jnp.where(f_acc, st.c_cur, st.i_f),
            qa=jnp.where(a1, st.qt, st.qa),
            va=jnp.where(a1, st.vt, st.va),
            ga=jnp.where(a1, st.gt, st.ga),
            lpa=jnp.where(f_acc, st.lpt, st.lpa),
            ha=jnp.where(f_acc, st.ht, st.ha),
            dha=jnp.where(f_acc, st.dht, st.dha),
            c_sim=jnp.where(f_acc, st.c_cur, st.c_sim),
        )
        # non-accepting forward trial: next level
        f_retry = f_done & ~f_acc
        # accepted + non-coarse: run the refined trial
        go_fine = f_acc & ~st.coarse
        # accepted + coarse: go backward (or finish if no levels below)
        go_bwd_f = f_acc & st.coarse

        # -- R2P completions (endpoint always taken)
        r_done = t_done & (st.phase == R2P)
        r1 = r_done[:, None]
        st = st._replace(
            qa=jnp.where(r1, st.qt, st.qa),
            va=jnp.where(r1, st.vt, st.va),
            ga=jnp.where(r1, st.gt, st.ga),
            lpa=jnp.where(r_done, st.lpt, st.lpa),
            ha=jnp.where(r_done, st.ht, st.ha),
            dha=jnp.where(r_done, st.dht, st.dha),
            c_sim=jnp.where(r_done, st.c_cur, st.c_sim),
        )

        # -- BWD completions (reference energy = the flipped endpoint's)
        b_done = t_done & (st.phase == BWD)
        b_err_ok = t_fin & (jnp.abs(st.ha - st.ht) < st.delta_cur)
        max_try = jnp.where(st.coarse, st.i_f - 1, max_c)
        b_found = b_done & b_err_ok
        b_next = b_done & ~b_err_ok & (st.c_cur < max_try)
        b_exhaust = b_done & ~b_err_ok & (st.c_cur >= max_try)
        i_b = jnp.where(b_found, st.c_cur,
                        jnp.where(st.coarse, st.i_f, max_c))

        # ---- phase transitions ----
        # forward retry: c+1 from the macro start
        def _reset_trial(st, mask, q, v, g, lp, h0):
            mk = mask[:, None]
            return st._replace(
                qt=jnp.where(mk, q, st.qt),
                vt=jnp.where(mk, v, st.vt),
                gt=jnp.where(mk, g, st.gt),
                lpt=jnp.where(mask, lp, st.lpt),
                ht=jnp.where(mask, h0, st.ht),
                dht=jnp.where(mask, 0.0, st.dht),
                fint=jnp.where(mask, 1.0, st.fint),
                k=jnp.where(mask, 0, st.k),
            )

        st = _reset_trial(st, f_retry, st.qs, st.vs, st.gs, st.lps,
                          st.h0s)
        st = st._replace(
            c_cur=jnp.where(f_retry, st.c_cur + 1, st.c_cur))

        # refined trial from the macro start at i_f + 1
        st = _reset_trial(st, go_fine, st.qs, st.vs, st.gs, st.lps,
                          st.h0s)
        st = st._replace(
            phase=jnp.where(go_fine, R2P, st.phase),
            c_cur=jnp.where(go_fine, st.i_f + 1, st.c_cur))

        # backward search starts from the flipped accepted endpoint
        to_bwd = go_bwd_f | r_done
        bwd_has_levels = jnp.where(st.coarse, st.i_f - 1, max_c) >= min_c
        start_bwd = to_bwd & bwd_has_levels
        st = _reset_trial(st, start_bwd, st.qa, -st.va, st.ga, st.lpa,
                          st.ha)
        st = st._replace(
            phase=jnp.where(start_bwd, BWD, st.phase),
            c_cur=jnp.where(start_bwd, min_c, st.c_cur))
        # backward retry at next level
        st = _reset_trial(st, b_next, st.qa, -st.va, st.ga, st.lpa,
                          st.ha)
        st = st._replace(c_cur=jnp.where(b_next, st.c_cur + 1, st.c_cur))

        # ------------------------------------------------------------
        # E. macro-step completion & orbit bookkeeping
        # ------------------------------------------------------------
        macro_done = (to_bwd & ~bwd_has_levels) | b_found | b_exhaust
        i_b = jnp.where(to_bwd & ~bwd_has_levels,
                        jnp.where(st.coarse, st.i_f, max_c), i_b)
        finite_m = jnp.isfinite(st.ha)
        md = macro_done
        ok = md & finite_m

        if proto_d:
            # hard reversibility rejection (adaptiveIntegrators.py:137)
            lwt = jnp.where(st.i_f == i_b, 0.0, LOG_ZERO).astype(dtype)
        else:
            lwt_f_term = jnp.where(st.coarse, lp_c, lp_f)
            lwt_b_term = jnp.where(
                st.c_sim == i_b, lp_c,
                jnp.where(st.c_sim == i_b + 1, lp_f, LOG_ZERO))
            lwt = (lwt_b_term - lwt_f_term).astype(dtype)

        # orientation back to orbit time
        v_orb = jnp.where(fwd_dir[:, None], st.va, -st.va)
        af = ok & fwd_dir
        ab = ok & ~fwd_dir
        rel = jnp.where(st.second, rel2_t, rel1_t)
        abs_id = jnp.where(fwd_dir, st.b_abs + rel, st.a_abs - rel)

        igr = (st.h_loc / jnp.exp2(st.c_sim.astype(dtype))) \
            * jnp.maximum(st.dha, 1e-30) ** (-1.0 / 3.0)

        lwt_sum_f = st.lwt_sum_f + jnp.where(af, lwt, 0.0)
        lwt_sum_b = st.lwt_sum_b + jnp.where(ab, lwt, 0.0)
        lwt_dir = jnp.where(fwd_dir, lwt_sum_f, lwt_sum_b)
        w_new = jnp.exp(-st.ha + st.mscale + lwt_dir)
        w_new_sum = st.w_new_sum + jnp.where(ok, w_new, 0.0)
        u_cat = rnd["cat_u"]
        sel = ok & (w_new_sum > thresh) & (u_cat * w_new_sum < w_new) \
            & ~is_d0
        sel = sel | (ok & is_d0)
        time_f2 = st.time_f + jnp.where(af, st.h_loc, 0.0)
        time_b2 = st.time_b + jnp.where(ab, st.h_loc, 0.0)
        signed_time = jnp.where(fwd_dir, time_f2, -time_b2)
        olen_mask = jnp.where(is_d0, md, ok)

        # multi-hot span-level store mask for the pair's first member:
        # level j >= 2 opens at rel1 == 1 (mod 2^j); closes (check) at
        # rel2 == 0 (mod 2^j) with rel2 >= 2^j, within the depth
        lev_ok = jlev <= depth_t[:, None]                 # [C,S]
        store_lvl = lev_ok & (
            (rel1_t[:, None] & (pw_lev - 1)) == 1)
        check_lvl = lev_ok & (
            (rel2_t[:, None] & (pw_lev - 1)) == 0) & (
            rel2_t[:, None] >= pw_lev)
        store_lvls = store_lvl & (ok & ~st.second)[:, None]
        sel1 = sel[:, None]
        st = st._replace(
            qp=jnp.where(af[:, None], st.qa, st.qp),
            vp=jnp.where(af[:, None], v_orb, st.vp),
            gp=jnp.where(af[:, None], st.ga, st.gp),
            lpp=jnp.where(af, st.lpa, st.lpp),
            hp=jnp.where(af, st.ha, st.hp),
            qm=jnp.where(ab[:, None], st.qa, st.qm),
            vm=jnp.where(ab[:, None], v_orb, st.vm),
            gm=jnp.where(ab[:, None], st.ga, st.gm),
            lpm=jnp.where(ab, st.lpa, st.lpm),
            hm=jnp.where(ab, st.ha, st.hm),
            neval_f=st.neval_f + jnp.where(md, st.nev_f, 0),
            neval_b=st.neval_b + jnp.where(md, st.nev_b, 0),
            h_min=jnp.where(md, jnp.minimum(st.h_min, st.ha), st.h_min),
            h_max=jnp.where(md, jnp.maximum(st.h_max, st.ha), st.h_max),
            if_min=jnp.where(md, jnp.minimum(st.if_min, st.i_f),
                             st.if_min),
            if_max=jnp.where(md, jnp.maximum(st.if_max, st.i_f),
                             st.if_max),
            c_min_d=jnp.where(md, jnp.minimum(st.c_min_d, st.c_sim),
                              st.c_min_d),
            c_max_d=jnp.where(md, jnp.maximum(st.c_max_d, st.c_sim),
                              st.c_max_d),
            lwt_min=jnp.where(md, jnp.minimum(st.lwt_min, lwt),
                              st.lwt_min),
            lwt_max=jnp.where(md, jnp.maximum(st.lwt_max, lwt),
                              st.lwt_max),
            n_states=st.n_states + md.astype(jnp.int32),
            n_if_neq_ib=st.n_if_neq_ib
            + (md & (st.i_f != i_b)).astype(jnp.int32),
            n_if_zero=st.n_if_zero + (md & (st.i_f == 0)).astype(
                jnp.int32),
            max_f_int=jnp.where(af, abs_id, st.max_f_int),
            max_b_int=jnp.where(ab, abs_id, st.max_b_int),
            time_f=time_f2, time_b=time_b2,
            lwt_sum_f=lwt_sum_f, lwt_sum_b=lwt_sum_b,
            w_new_sum=w_new_sum,
            q_prop=jnp.where(sel1, st.qa, st.q_prop),
            lp_prop=jnp.where(sel, st.lpa, st.lp_prop),
            g_prop=jnp.where(sel1, st.ga, st.g_prop),
            sel_l=jnp.where(sel, abs_id, st.sel_l),
            idx_time=jnp.where(sel, signed_time, st.idx_time),
            orbit_len=st.orbit_len + jnp.where(olen_mask, st.h_loc, 0.0),
        )
        if "slab" not in ablate:
            sdt = st.slab_q.dtype
            st = st._replace(
                slab_q=jnp.where(store_lvls[:, :, None],
                                 st.qa[:, None, :].astype(sdt),
                                 st.slab_q),
                slab_v=jnp.where(store_lvls[:, :, None],
                                 v_orb[:, None, :].astype(sdt),
                                 st.slab_v),
            )

        if warmup is not None and warmup.adapt_h:
            # every finite completed macro step feeds the step-size
            # model during warmup (transition.py pushes with the same
            # cadence; WALNUTS.py:139-141,313)
            in_wu_m = st.it < warmup.warmup_iter
            st = st._replace(p2h=p2_push(
                st.p2h, jnp.log(igr), mask=md & finite_m & in_wu_m))

        forced = md & ~finite_m

        # ---- pair / row sequencing --------------------------------
        # first-of-pair completion: remember the state, start second
        # (row_done below must use the PRE-update pair flag)
        second_prev = st.second
        first_done = md & ~second_prev & ~is_d0 & finite_m
        fd1 = first_done[:, None]
        st = st._replace(
            q1=jnp.where(fd1, st.qa, st.q1),
            v1=jnp.where(fd1, v_orb, st.v1),
            second=st.second | first_done,
            k=jnp.where(first_done, -1, st.k),
        )

        # second-of-pair (or depth-0) completion: checks + row advance
        row_done = (md & (second_prev | is_d0) & finite_m) | forced
        pair_ok = md & second_prev & finite_m

        # adjacent U-turn between q1 and the new state
        eq = jnp.where(fwd_dir[:, None], st.q1, st.qa)
        ev = jnp.where(fwd_dir[:, None], st.v1, v_orb)
        lq = jnp.where(fwd_dir[:, None], st.qa, st.q1)
        lv = jnp.where(fwd_dir[:, None], v_orb, st.v1)
        adj_ut = uturn(eq, ev, lq, lv)

        # fused merge checks against span-start slab states.  The
        # dots expand as differences of direct products —
        # sum(v*(qa-slab_q)) = v.qa - sum(v*slab_q) — so every
        # [C, S, D] reduction fuses multiply+reduce over the raw slab
        # with NO shared [C, S, D] intermediate: the original
        # d_f = qa - slab_q was consumed by both dots, which made XLA
        # materialise and re-read a 20 MB temporary every round.
        if "slab" in ablate:
            merge_ut = jnp.zeros((C,), bool)
        else:
            lvl_mask = check_lvl
            vq = jnp.sum(v_orb * st.qa, axis=-1)          # [C]
            # .astype inlined per-use: a shared f32 copy of the slab
            # would re-materialise the [C, S, D] temporary this form
            # exists to avoid
            dot_new = vq[:, None] - jnp.sum(
                st.slab_q.astype(dtype) * v_orb[:, None, :], axis=-1)
            dot_old = jnp.sum(
                st.slab_v.astype(dtype) * st.qa[:, None, :],
                axis=-1) - jnp.sum(
                st.slab_v.astype(dtype) * st.slab_q.astype(dtype),
                axis=-1)
            ut_all = jnp.where(fwd_dir[:, None],
                           (dot_new < 0.0) | (dot_old < 0.0),
                           (dot_new > 0.0) | (dot_old > 0.0))
            merge_ut = jnp.any(lvl_mask & ut_all, axis=1)
        depth_done = st.depth_done | (pair_ok & (adj_ut | merge_ut))
        st = st._replace(depth_done=depth_done,
                         stop_code=jnp.where(forced, 999, st.stop_code))

        done = forced

        # depth-done chains mid-depth jump to the resolution row;
        # depth-done chains AT the resolution row resolve now
        jump = live & st.depth_done & ~last
        arrived = live & st.depth_done & last & (st.k < 0)
        p_mask = live & last & ((row_done & ~forced) | arrived)
        su = p_mask & st.depth_done
        go = p_mask & ~st.depth_done

        u_acc = rnd["acc_u"]
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
                          st.idx_time / jnp.maximum(
                              st.time_f + st.time_b, 1e-30),
                          st.index_stat)),
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
        done = (done | exhausted) & live
        st = st._replace(
            w_old_sum=jnp.where(cont, st.w_old_sum + st.w_new_sum,
                                st.w_old_sum),
            b_abs=jnp.where(cont & fwd_dir, st.b_abs + pw, st.b_abs),
            a_abs=jnp.where(cont & ~fwd_dir, st.a_abs - pw, st.a_abs),
            depth_done=st.depth_done & ~p_mask,
        )

        # ---- finalise transitions ----------------------------------
        either_passive = (st.lwt_sum_b < log_zero_edge) | (
            st.lwt_sum_f < log_zero_edge)
        nst_ = jnp.maximum(st.n_states, 1).astype(dtype)
        if "stage" in ablate:
            diag_row = None
        else:
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
            st.n_if_neq_ib.astype(dtype) / nst_,
            st.h_cur,
            st.n_if_zero.astype(dtype) / nst_,
            st.h_max - st.h_min,
            st.delta_cur,
            st.stop_code.astype(dtype),
            st.n_doubl_computed.astype(dtype),
            st.c_min_d.astype(dtype), st.c_max_d.astype(dtype),
            st.index_stat,
        ], axis=0)  # [24, C]: row-contiguous (a [C, 24] stack pays a
        #            strided-tile write every round; transpose once
        #            per flush instead)
        # stage completed transitions into a free pending slot; the
        # ring-buffer writes run only on flush rounds (only ~1% of
        # chains complete per round).  The slot records the ABSOLUTE
        # draw index; the flush takes it mod R / mod Rd, so the
        # samples and diagnostics rings each stay uniform most-recent
        # rings even when Rd does not divide R.
        if "stage" in ablate:
            pend0, pend1 = st.pend0, st.pend1
            prow0, prow1 = st.prow0, st.prow1
            pgen0, pgen1 = st.pgen0, st.pgen1
            pdiag0, pdiag1 = st.pdiag0, st.pdiag1
        else:
            row = st.it
            gen = target.generated(st.q_prop)
            store = done
            if stop_mode == "min_per_chain":
                # first-K draws only
                store = done & (st.it < num_iter)
            use0 = store & ~st.pend0
            use1 = store & st.pend0   # slot 1 free by construction
            pend0 = st.pend0 | use0
            pend1 = st.pend1 | use1
            prow0 = jnp.where(use0, row, st.prow0)
            prow1 = jnp.where(use1, row, st.prow1)
            pgen0 = jnp.where(use0[:, None], gen, st.pgen0)
            pgen1 = jnp.where(use1[:, None], gen, st.pgen1)
            pdiag0 = jnp.where(use0[None, :], diag_row, st.pdiag0)
            pdiag1 = jnp.where(use1[None, :], diag_row, st.pdiag1)

        if warmup is not None:
            # per-chain tuning update at transition completion, after
            # the diagnostics row is latched (the reference records the
            # row before adapting, WALNUTS.py:670-713)
            adone = done & (st.it < warmup.warmup_iter)
            if warmup.adapt_delta:
                fac = (st.h_max - st.h_min) / st.delta_cur
                p2d = p2_push(st.p2d, fac, mask=adone)
                st = st._replace(p2d=p2d)
                # in pooled mode the tuning moves only at consensus
                # flushes, so every chain carries one (H, delta)
                if not warmup.pooled:
                    dq = p2_quantile(p2d)
                    st = st._replace(delta_cur=jnp.where(
                        adone & (p2d.npush > 10) & (dq > 0),
                        warmup.adapt_delta_target / dq, st.delta_cur))
            if warmup.adapt_h and not warmup.pooled:
                h_new = st.delta_cur ** (1.0 / 3.0) * jnp.exp(
                    p2_quantile(st.p2h))
                st = st._replace(h_cur=jnp.where(
                    adone & (st.p2h.npush > 10), h_new, st.h_cur))

        samples, diags = st.samples, st.diags

        # ---- advance t / it ----------------------------------------
        # chains advancing to a new row (or same row's pair-second keep
        # t); completed rows move to t+1; mid-depth depth-done jumps
        advance_row = (row_done & ~done & ~forced) | (jump & ~p_mask) \
            | (p_mask & ~done & ~su) | (su & False)
        t_next = jnp.where(
            st.depth_done & ~last & (row_done | jump),
            pw_d - 1,
            st.t + 1)
        new_t = jnp.where(done | ~live, 0,
                          jnp.where(row_done | jump, t_next, st.t))
        # chains that resolved su (not done handled) — su always done
        d1 = done[:, None]
        st = st._replace(
            n=n + 1,
            t=new_t,
            it=st.it + done.astype(jnp.int32),
            qc=jnp.where(d1, st.q_prop, st.qc),
            lpc=jnp.where(done, st.lp_prop, st.lpc),
            gc=jnp.where(d1, st.g_prop, st.gc),
            samples=samples, diags=diags,
            pend0=pend0, pend1=pend1,
            prow0=prow0, prow1=prow1,
            pgen0=pgen0, pgen1=pgen1,
            pdiag0=pdiag0, pdiag1=pdiag1,
            second=st.second & ~(row_done | done | jump),
            k=jnp.where(row_done | done | jump, -1, st.k),
        )
        return st

    return body


@partial(jax.jit, static_argnames=("target", "cfg", "num_iter",
                                   "stop_mode", "warmup", "ring_rows",
                                   "diag_rows", "rounds", "rng",
                                   "micro_unroll", "round_unroll",
                                   "ablate"))
def run_walnuts_fused(key, q0, h_step, delta, *, target,
                      cfg: WalnutsConfig, num_iter: int,
                      stop_mode: str = "per_chain",
                      warmup: WarmupConfig = None,
                      ring_rows: int = None,
                      diag_rows: int = None,
                      rounds: int = None,
                      mk_state=None,
                      adapt_state=None,
                      rng: str = "hash",
                      micro_unroll: int = 1,
                      round_unroll: int = 1,
                      ablate: tuple = ()):
    """Stream WALNUTS transitions with up to ``micro_unroll`` batched
    micro steps per round.

    ``micro_unroll`` (K): each loop round advances every integrating
    chain by up to K back-to-back leapfrog micro steps; only the live
    trial state is rewritten per sub-step, so the ~35 bookkeeping
    carries amortise over K gradient evaluations.  A chain whose
    trial boundary falls mid-round idles the remaining sub-steps
    (bounded waste < (K-1) steps per trial), so K should stay near
    the typical trial length 2^c — K=2..4 for adapted WALNUTS, K=1
    for fixed-leapfrog NUTS (every trial is a single step).  The
    per-chain hash-RNG stream is keyed by round index, so different K
    produce different (equally valid) random streams; ``rounds=`` caps
    and resume semantics are per round, not per micro step.

    ``cfg.integrator`` selects the protocol: ``adapt_leapfrog_r2p``
    (randomized two-point, the default), ``adapt_leapfrog_d``
    (deterministic halving with the hard If==Ib reversibility check),
    or ``fixed_leapfrog`` (single unchecked leapfrog per macro step =
    multinomial NUTS).  The other integrator families run on the scan
    and streaming engines.

    ``warmup``: when given, ``h_step``/``delta`` are *initial* values
    and each chain adapts both in-loop for its first
    ``warmup.warmup_iter`` transitions, with the scan driver's rules
    (``WALNUTSpy/WALNUTS.py:701-713``): the macro step from a P2
    quantile of ``log igrConst`` pushed at every accepted macro step,
    the tolerance from a P2 quantile of the per-transition
    energy-error inflation factor (the scan driver keeps the exact
    history quantile; P2 approximates it so the carry stays O(1) per
    chain).  ``warmup.pooled`` applies a batch-median consensus at
    every flush boundary.  The call then also returns the final
    per-chain ``(h, delta)``.

    ``stop_mode``:

    * ``"per_chain"`` — every chain produces exactly ``num_iter``
      draws.  Chains finish at very different speeds (orbit depths
      span 2^2..2^7 rounds per transition), so the batch spends a long
      tail at low utilisation waiting for the slowest chain.
    * ``"total"`` — run until ``C * num_iter`` draws exist in total;
      each chain's buffer is a ring holding its most recent
      ``num_iter`` draws and no chain ever idles (utilisation stays
      ~100% to the end).  Chains contribute unequal draw counts.
      CAUTION: a chain's draw count under a fixed *round* budget is a
      path-dependent stopping time (slow = deep-in-the-funnel chains
      produce fewer draws), so pooling the draws count-weighted is
      length-biased — use for throughput probes, not posterior
      estimates.
    * ``"min_per_chain"`` — run until EVERY chain has ``num_iter``
      draws, but chains that reach quota keep transitioning (no idle
      tail; all work counted).  The ring stores each chain's *first*
      ``num_iter`` draws: a fixed transition count per chain, so the
      returned rectangle is an unbiased equal-weight sample.  This is
      the mode for timed runs whose draws feed estimates.

    Returns ``(samples [R, C, dg], diagnostics [Rd, C, 24],
    q_final [C, D], counts [C], total_grads)`` (plus ``(h, delta)``
    when ``warmup`` is given, plus the carryable engine state when
    ``rounds`` is given), where ``R = ring_rows or num_iter`` and
    ``Rd = diag_rows or R``: each chain's buffer is a ring over
    ``it % R`` holding its most recent draws.  Pass a small
    ``ring_rows``/``diag_rows`` for runs that don't need the history
    (a multi-GB carried output ring is wasted device memory).

    ``rng``: ``"hash"`` (default, one semantics across all fast
    engines) derives every draw from a splitmix32 counter hash of
    (seed, global chain id, absolute round, purpose) via
    :func:`make_hash_draw` — per-chain reproducible.  ``"global"`` (legacy) keys each
    round's draws by the global round counter with threefry (a
    chain's stream then depends on when the whole batch reaches each
    round — fine distributionally, but not per-chain reproducible
    across batch compositions).

    ``rounds`` / ``mk_state``: round-capped invocations with full
    state carry.  With ``rounds=K`` the loop ALSO exits after ~K
    rounds (flush-period granularity) and the full engine state —
    including mid-transition phase state and the output rings — is
    appended to the return tuple; pass it back as ``mk_state`` (with
    the same ``key`` and static args) to continue exactly where the
    previous invocation stopped.  This bounds every device program to
    a short fixed cost, so the host can report progress and keep a
    deadline between invocations, without draw-quota barriers or
    per-(C, num_iter) recompiles: the stream of invocations is one
    uninterrupted run.
    """
    C, D = q0.shape
    dtype = q0.dtype
    m = cfg.m
    if not 1 <= m <= 32:
        # doubling directions for a transition live in ONE uint32
        # bitmask per chain (xi_bits); bit shifts past 31 would yield
        # silently biased directions rather than an error
        raise ValueError(f"cfg.m must be in [1, 32], got {m}")
    if cfg.integrator not in ("adapt_leapfrog_r2p", "adapt_leapfrog_d",
                              "fixed_leapfrog"):
        raise ValueError(
            "the fused engine implements the leapfrog R2P/D/fixed "
            f"protocols; got integrator={cfg.integrator!r} (use "
            "run_walnuts / run_walnuts_streaming for the other "
            "integrator families)")
    min_c = 0 if cfg.integrator == "fixed_leapfrog" else cfg.igr.min_c
    # the slab stores only span-start states, indexed by span LEVEL
    # (log2 span size, levels 2..m-1): at most m-2 live at once
    S = max(m - 2, 1)
    dg = target.generated_dim
    R = num_iter if ring_rows is None else ring_rows
    Rd = R if diag_rows is None else diag_rows

    lp0, g0 = target.logp_grad(q0)

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    zb = jnp.zeros((C,), bool)
    ones = jnp.ones((C,), dtype)
    inf = jnp.asarray(jnp.inf, dtype)

    st = _MState(
        n=jnp.zeros((), jnp.int32), t=zi, it=zi,
        phase=zi, c_cur=jnp.full((C,), min_c, jnp.int32), k=zi,
        second=zb, h_loc=jnp.full((C,), 1.0, dtype), coarse=zb,
        i_f=zi,
        qs=q0, vs=jnp.zeros_like(q0), gs=g0, lps=lp0, h0s=zf,
        qt=q0, vt=jnp.zeros_like(q0), gt=g0, lpt=lp0, ht=zf,
        dht=zf, fint=ones,
        qa=q0, va=jnp.zeros_like(q0), ga=g0, lpa=lp0, ha=zf, dha=zf,
        c_sim=zi, nev_f=zi, nev_b=zi,
        q1=q0, v1=jnp.zeros_like(q0),
        qp=q0, vp=jnp.zeros_like(q0), gp=g0, lpp=lp0, hp=zf,
        qm=q0, vm=jnp.zeros_like(q0), gm=g0, lpm=lp0, hm=zf,
        qc=q0, lpc=lp0, gc=g0,
        q_prop=q0, lp_prop=lp0, g_prop=g0,
        q_prop_last=q0, lp_prop_last=lp0, g_prop_last=g0,
        mscale=zf, lwt_sum_f=zf, lwt_sum_b=zf,
        w_new_sum=zf, w_old_sum=ones,
        sel_l=zi, sel_l_old=zi,
        idx_time=zf, index_stat=zf, index_stat_old=zf,
        time_f=zf, time_b=zf, orbit_len=zf, orbit_len_sam=zf,
        a_abs=zi, b_abs=zi, xi_bits=jnp.zeros((C,), jnp.uint32),
        depth_done=zb, stop_code=zi, both_ends_passive=zb,
        n_doubl_sampled=zi, n_doubl_computed=zi,
        max_f_int=zi, max_b_int=zi,
        neval_f=zi, neval_b=zi,
        h_min=zf, h_max=zf,
        if_min=jnp.full((C,), _BIG_I32), if_max=jnp.full((C,), -_BIG_I32),
        c_min_d=jnp.full((C,), _BIG_I32),
        c_max_d=jnp.full((C,), -_BIG_I32),
        lwt_min=jnp.full((C,), inf), lwt_max=jnp.full((C,), -inf),
        n_states=zi, n_if_neq_ib=zi, n_if_zero=zi,
        # slab in bf16 under f32 runs: the span slab is pure store/
        # sign-check state (U-turn dots of O(1) quantities), and its
        # two [C, S, D] arrays are the largest per-round state by
        # shape; checks cast up to f32 inside fused multiply-reduces,
        # so only storage is rounded.  f64 runs keep an f64 slab.
        slab_q=jnp.zeros((C, S, D), _slab_dtype(dtype)),
        slab_v=jnp.zeros((C, S, D), _slab_dtype(dtype)),
        samples=jnp.zeros((R, C, dg), dtype),
        diags=jnp.zeros((Rd, C, 24), dtype),
        grad_ct=zi,
        pend0=zb, pend1=zb, prow0=zi, prow1=zi,
        pgen0=jnp.zeros((C, dg), dtype),
        pgen1=jnp.zeros((C, dg), dtype),
        pdiag0=jnp.zeros((24, C), dtype),
        pdiag1=jnp.zeros((24, C), dtype),
        h_cur=jnp.broadcast_to(jnp.asarray(h_step, dtype), (C,)),
        delta_cur=jnp.broadcast_to(jnp.asarray(delta, dtype), (C,)),
        p2h=(adapt_state[0] if adapt_state is not None else
             p2_init(1.0 - (warmup.adapt_h_target if warmup else 0.8),
                     (C,), dtype)),
        p2d=(adapt_state[1] if adapt_state is not None else
             p2_init(warmup.adapt_delta_quantile if warmup else 0.9,
                     (C,), dtype)),
    )
    # start: every chain needs fresh-init; mark by t=0 & a sentinel so
    # the first round initialises before integrating
    st = st._replace(k=jnp.full((C,), -1, jnp.int32))
    if mk_state is not None:
        st = mk_state          # resume; the fresh init above is DCE'd

    total_target = C * num_iter
    n0 = st.n

    def cond(st):
        if stop_mode == "total":
            live = jnp.sum(st.it) < total_target
        else:
            live = jnp.any(st.it < num_iter)
        if rounds is not None:
            live = live & (st.n < n0 + rounds)
        return live

    round_body = _make_round_body(
        target=target, cfg=cfg, warmup=warmup, stop_mode=stop_mode,
        num_iter=num_iter, R=R, C=C, D=D, dtype=dtype,
        micro_unroll=micro_unroll, ablate=ablate)

    if rng == "hash":
        seed = jax.random.randint(jax.random.fold_in(key, 777),
                                  (1,), 0, 2 ** 30, jnp.int32)
        cid = jnp.arange(C, dtype=jnp.uint32)
        hash_draw = make_hash_draw(seed[0], cid, D, dtype)

    def body(st):
        rnd = (hash_draw(st.n) if rng == "hash" else
               _draw_round_rands(key, st.n, C, D, dtype))
        return round_body(st, rnd)

    def flush(st):
        """Drain both pending slots into the output rings with a
        dense one-hot masked write, which fuses into one streaming
        pass over the rings (a scatter at [C] row indices is the
        alternative; neither is measured on the GPU yet)."""
        rows = jnp.arange(R, dtype=jnp.int32)
        oh0 = st.pend0[None, :] & (
            st.prow0[None, :] % R == rows[:, None])
        oh1 = st.pend1[None, :] & (
            st.prow1[None, :] % R == rows[:, None])
        samples = jnp.where(oh0[:, :, None], st.pgen0[None], st.samples)
        samples = jnp.where(oh1[:, :, None], st.pgen1[None], samples)
        if Rd == R:
            dh0, dh1 = oh0, oh1
        else:
            rows_d = jnp.arange(Rd, dtype=jnp.int32)
            dh0 = st.pend0[None, :] & (
                st.prow0[None, :] % Rd == rows_d[:, None])
            dh1 = st.pend1[None, :] & (
                st.prow1[None, :] % Rd == rows_d[:, None])
        diags = jnp.where(dh0[:, :, None], st.pdiag0.T[None], st.diags)
        diags = jnp.where(dh1[:, :, None], st.pdiag1.T[None], diags)
        zb_ = jnp.zeros_like(st.pend0)
        st = st._replace(samples=samples, diags=diags,
                         pend0=zb_, pend1=zb_)
        if warmup is not None and warmup.pooled:
            # batch-median consensus once per flush period (the scan
            # driver pools every iteration; at the megakernel's round
            # granularity the flush boundary is the natural cadence).
            # Pooled warmup is batch-scoped: consensus applies until
            # EVERY chain completed warmup_iter transitions, so all
            # chains end warmup with the identical (H, delta) the scan
            # driver's lockstep pooling produces.
            in_wu = jnp.min(st.it) < warmup.warmup_iter
            if warmup.adapt_delta:
                dqs = p2_quantile(st.p2d)
                med = jnp.nanmedian(jnp.where(
                    st.p2d.npush > 10, dqs, jnp.nan))
                st = st._replace(delta_cur=jnp.where(
                    in_wu & jnp.isfinite(med) & (med > 0),
                    warmup.adapt_delta_target / med, st.delta_cur))
            if warmup.adapt_h:
                med = jnp.nanmedian(jnp.where(
                    st.p2h.npush > 10, p2_quantile(st.p2h), jnp.nan))
                st = st._replace(h_cur=jnp.where(
                    in_wu & jnp.isfinite(med),
                    st.delta_cur ** (1.0 / 3.0) * jnp.exp(med),
                    st.h_cur))
        return st

    # round_unroll (U): chain U complete round bodies inside one
    # fori_loop iteration.  Draws are keyed by the absolute round
    # counter st.n (incremented inside the body), so ANY U consumes
    # the identical RNG stream and runs the identical algorithm —
    # unlike micro_unroll, this is purely an XLA scheduling hint: the
    # compiler may fuse producer->consumer chains across the unrolled
    # bodies, so the ~25 [C, D] carries + the [C, S, D] slab can stay
    # on chip across U rounds instead of round-tripping HBM every
    # round.  Different U values are
    # different XLA programs, so results match only to fp rounding
    # (reassociated reductions) — measured last-ulp state deltas,
    # same class of variation as switching backends.
    if round_unroll < 1 or _FLUSH_EVERY % round_unroll != 0:
        raise ValueError(
            f"round_unroll must divide _FLUSH_EVERY={_FLUSH_EVERY}, "
            f"got {round_unroll}")

    def outer_body(st):
        def fused(i, s):
            for _ in range(round_unroll):
                s = body(s)
            return s

        st = jax.lax.fori_loop(0, _FLUSH_EVERY // round_unroll,
                               fused, st)
        return flush(st)

    # termination is checked once per flush period; the <=15 extra
    # rounds of overshoot only add draws (ring semantics unchanged)
    st = jax.lax.while_loop(cond, outer_body, st)
    if jax.config.jax_enable_x64:
        total_grads = jnp.sum(st.grad_ct.astype(jnp.int64))  # exact
    else:
        # x64 off: the f32 sum carries ~1e-7 relative rounding; exact
        # per-chain int32 counts stay available in st.grad_ct for
        # rounds-capped callers, which sum them on the host in int64
        total_grads = jnp.sum(st.grad_ct.astype(jnp.float32))
    if warmup is not None:
        out = (st.samples, st.diags, st.qc, st.it, total_grads,
               st.h_cur, st.delta_cur, (st.p2h, st.p2d))
    else:
        out = (st.samples, st.diags, st.qc, st.it, total_grads)
    if rounds is not None:
        out = out + (st,)
    return out
