"""Adaptive macro-step integrators (layer L1).

Each integrator advances a batch of chains by one *macro* step of
per-chain length ``h_macro``, internally choosing a refinement level
``c`` so that ``2^c`` micro steps meet an error tolerance ``delta``,
and returns the reversibility bookkeeping ``(If, Ib, c, lwt)`` that the
orbit layer folds into its multinomial weights.

Semantics follow the reference integrator suite
(``WALNUTSpy/adaptiveIntegrators.py``):

* ``fixed_leapfrog``         — plain 1-step leapfrog; WALNUTS degrades
  to multinomial NUTS (``adaptiveIntegrators.py:49-59``).
* ``adapt_leapfrog_d``       — deterministic halving on the endpoint
  energy error, backward scan for ``Ib``, hard reject weight when
  ``If != Ib`` (``adaptiveIntegrators.py:65-137``).
* ``adapt_yoshida_d``        — same protocol over a 4th-order Yoshida
  composition (``adaptiveIntegrators.py:142-240``).
* ``adapt_leapfrog_flow_d``  — same protocol with a per-micro-step
  Hermite flow-error criterion (``adaptiveIntegrators.py:246-356``).
* ``adapt_leapfrog_r2p``     — randomized two-point refinement with a
  proper Hastings weight; the paper's workhorse
  (``adaptiveIntegrators.py:361-475``).

The *execution model* is inverted from the reference: instead of one
chain early-exiting a Python search loop, a shared refinement counter
``c`` sweeps upward in a ``lax.while_loop`` and every chain that has
not yet accepted re-integrates its own macro step at ``2^c`` micro
steps, with accepted chains masked out.  The loop exits when the
slowest chain accepts, so a batch pays the *max* refinement depth over
chains per macro step — the price of dense fixed-shape execution,
bought back by running thousands of chains per device.
"""

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import LOG_ZERO
from ..utils.tree import tree_where
from .leapfrog import (
    PhasePoint,
    MultistepResult,
    masked_multistep,
    leapfrog_step,
    yoshida_step,
    leapfrog_flow_step,
    implicit_midpoint_step,
)

_IGR_FLOOR = 1e-30  # guards max_dh == 0 -> inf in the d^{-1/3} model


class IntegratorConfig(NamedTuple):
    """Static tuning record (reference ``integratorAuxPar``,
    ``adaptiveIntegrators.py:36-44``)."""

    min_c: int = 0
    max_c: int = 10
    r2p_prob0: float = 2.0 / 3.0
    max_fp_iter: int = 30
    fp_tol: float = 1.0e-8
    fp_newton: bool = False
    rescaled_grad_thresh: float = 5.0


class IntegratorResult(NamedTuple):
    """Batched analogue of the reference ``integratorReturn``
    (``adaptiveIntegrators.py:17-33``).  ``v`` is re-oriented to orbit
    time (the reference's ``xi*vOut``)."""

    q: jnp.ndarray          # [C, D]
    v: jnp.ndarray          # [C, D]
    g: jnp.ndarray          # [C, D]
    lp: jnp.ndarray         # [C]
    h_end: jnp.ndarray      # [C] Hamiltonian at the new state
    n_eval_f: jnp.ndarray   # [C] int32 logical gradient evals, forward
    n_eval_b: jnp.ndarray   # [C] int32 logical gradient evals, backward
    i_f: jnp.ndarray        # [C] int32
    i_b: jnp.ndarray        # [C] int32
    c: jnp.ndarray          # [C] int32 refinement actually simulated
    lwt: jnp.ndarray        # [C] log Hastings weight contribution
    igr_const: jnp.ndarray  # [C] h_micro * max|dH|^{-1/3} local-error const


def _pow2(c):
    return jnp.left_shift(jnp.ones((), jnp.int32), c)


def _igr(h_micro, max_dh):
    return h_micro * jnp.maximum(max_dh, _IGR_FLOOR) ** (-1.0 / 3.0)


def _trial_error(trial: MultistepResult, h0, criterion):
    if criterion == "energy":
        return jnp.abs(h0 - trial.h_end)
    return trial.max_step_err


def _forward_search(target, start, h0, h_macro, delta, inv_mass, cfg,
                    step_fn, criterion, active):
    """Sweep c = min_c..max_c; per chain take the first accepted trial,
    or the max_c trial if none accepts (``adaptiveIntegrators.py:69-94``)."""
    zeros_i = jnp.zeros_like(h0, jnp.int32)
    init_result = MultistepResult(
        start, h0, jnp.zeros_like(h0), jnp.zeros_like(h0),
        jnp.ones(h0.shape, bool), zeros_i,
    )

    def cond(carry):
        c, done, *_ = carry
        return (c <= cfg.max_c) & jnp.any(~done)

    def body(carry):
        c, done, result, i_f, igr, neval = carry
        nsteps = jnp.where(done, 0, _pow2(c))
        h_micro = h_macro / _pow2(c).astype(h_macro.dtype)
        trial = masked_multistep(target, start, h0, h_micro, nsteps,
                                 inv_mass, step_fn)
        err = _trial_error(trial, h0, criterion)
        accept = trial.all_finite & (err < delta)
        take = ~done & (accept | (c == cfg.max_c))
        result = tree_where(take, trial, result)
        i_f = jnp.where(take, c, i_f)
        igr = jnp.where(take, _igr(h_micro, trial.max_dh), igr)
        neval = neval + trial.n_evals
        return (c + 1, done | take, result, i_f, igr, neval)

    init = (jnp.asarray(cfg.min_c, jnp.int32), ~active, init_result,
            zeros_i, jnp.zeros_like(h0), zeros_i)
    _, _, result, i_f, igr, neval = jax.lax.while_loop(cond, body, init)
    return result, i_f, igr, neval


def _backward_search(target, end: PhasePoint, h0b, h_macro, delta, inv_mass,
                     cfg, step_fn, criterion, max_try, default_ib, active):
    """Sweep c = min_c..max_try (per-chain bound) from the flipped
    endpoint; first accepted c is ``Ib``
    (``adaptiveIntegrators.py:107-132,440-464``)."""
    start_b = PhasePoint(end.q, -end.v, end.g, end.lp)
    zeros_i = jnp.zeros_like(h0b, jnp.int32)

    def cond(carry):
        c, found, *_ = carry
        return jnp.any(~found & (c <= max_try))

    def body(carry):
        c, found, i_b, neval = carry
        do = ~found & (c <= max_try)
        nsteps = jnp.where(do, _pow2(c), 0)
        h_micro = h_macro / _pow2(c).astype(h_macro.dtype)
        trial = masked_multistep(target, start_b, h0b, h_micro, nsteps,
                                 inv_mass, step_fn)
        err = _trial_error(trial, h0b, criterion)
        accept = do & trial.all_finite & (err < delta)
        i_b = jnp.where(accept, c, i_b)
        neval = neval + trial.n_evals
        return (c + 1, found | accept, i_b, neval)

    init = (jnp.asarray(cfg.min_c, jnp.int32), ~active, default_ib, zeros_i)
    _, _, i_b, neval = jax.lax.while_loop(cond, body, init)
    return i_b, neval


def _oriented_start(q, v, g, lp, xi):
    return PhasePoint(q, xi[:, None] * v, g, lp)


def _finish(start, end: PhasePoint, xi, h_end, active, lp_in, h0,
            n_eval_f, n_eval_b, i_f, i_b, c_sim, lwt, igr):
    """Re-orient the velocity to orbit time and freeze inactive chains."""
    a1 = active[:, None]
    zero = jnp.zeros_like(h0)
    return IntegratorResult(
        q=jnp.where(a1, end.q, start.q),
        v=jnp.where(a1, xi[:, None] * end.v, xi[:, None] * start.v),
        g=jnp.where(a1, end.g, start.g),
        lp=jnp.where(active, end.lp, lp_in),
        h_end=jnp.where(active, h_end, h0),
        n_eval_f=jnp.where(active, n_eval_f, 0),
        n_eval_b=jnp.where(active, n_eval_b, 0),
        i_f=jnp.where(active, i_f, 0),
        i_b=jnp.where(active, i_b, 0),
        c=jnp.where(active, c_sim, 0),
        lwt=jnp.where(active, lwt, zero),
        igr_const=jnp.where(active, igr, jnp.ones_like(h0)),
    )


# ----------------------------------------------------------------------
def fixed_leapfrog(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                   inv_mass, active, cfg):
    """Plain single leapfrog step (``adaptiveIntegrators.py:49-59``)."""
    start = _oriented_start(q, v, g, lp, xi)
    hh = jnp.where(active, h_macro, 0.0)
    end, _, _, _ = leapfrog_step(target, start, hh, inv_mass)
    h_end = -end.lp + 0.5 * jnp.sum(
        end.v * (end.v if inv_mass is None else inv_mass * end.v), axis=-1
    )
    igr = h_macro * jnp.maximum(1.0e-10, jnp.abs(h0 - h_end)) ** (-1.0 / 3.0)
    zi = jnp.zeros_like(h0, jnp.int32)
    one = jnp.ones_like(h0, jnp.int32)
    return _finish(start, end, xi, h_end, active, lp, h0,
                   one, zi, zi, zi, zi, jnp.zeros_like(h0), igr)


def _adaptive_d(key, target, q, v, g, lp, h0, h_macro, xi, delta, inv_mass,
                active, cfg, step_fn, criterion):
    """Deterministic halving protocol shared by the D-family."""
    start = _oriented_start(q, v, g, lp, xi)
    fw, i_f, igr, n_eval_f = _forward_search(
        target, start, h0, h_macro, delta, inv_mass, cfg, step_fn,
        criterion, active)
    end = fw.state
    bw_active = active & (i_f > cfg.min_c)
    i_b, n_eval_b = _backward_search(
        target, end, fw.h_end, h_macro, delta, inv_mass, cfg, step_fn,
        criterion, max_try=i_f - 1, default_ib=i_f, active=bw_active)
    lwt = jnp.where(i_f != i_b, LOG_ZERO, 0.0).astype(h0.dtype)
    return _finish(start, end, xi, fw.h_end, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, i_f, lwt, igr)


def adapt_leapfrog_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                     inv_mass, active, cfg):
    return _adaptive_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, leapfrog_step, "energy")


def adapt_yoshida_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                    inv_mass, active, cfg):
    return _adaptive_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, yoshida_step, "energy")


def adapt_leapfrog_flow_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                          inv_mass, active, cfg):
    # Reference flow variant searches from c=0 regardless of min_c
    # (``adaptiveIntegrators.py:250``); reproduce by forcing min_c=0.
    cfg0 = cfg._replace(min_c=0)
    return _adaptive_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg0, leapfrog_flow_step, "flow")


def adapt_implicit_midpoint_d(key, target, q, v, g, lp, h0, h_macro, xi,
                              delta, inv_mass, active, cfg):
    """Implicit midpoint with per-micro-step fixed-point (or Newton)
    solves under the deterministic halving protocol
    (``adaptiveIntegrators.py:478-641``).  A refinement level at which
    any micro step fails to converge is rejected via the trial's
    ``all_finite`` flag; if that persists through ``max_c`` the
    returned energy is non-finite and the orbit layer force-rejects
    (stop code 999) instead of the reference's ``sys.exit``.
    """
    step_fn = partial(
        implicit_midpoint_step,
        fp_tol=cfg.fp_tol, max_fp_iter=cfg.max_fp_iter, newton=cfg.fp_newton)
    return _adaptive_d(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg, step_fn, "energy")


def adapt_leapfrog_r2p(key, target, q, v, g, lp, h0, h_macro, xi, delta,
                       inv_mass, active, cfg):
    """Randomized two-point refinement (``adaptiveIntegrators.py:361-475``).

    With probability ``r2p_prob0`` the macro step is simulated at the
    minimal accepted refinement ``If``, otherwise at ``If + 1``; the
    backward pass recomputes the minimal refinement ``Ib`` seen from
    the endpoint, and ``lwt = log p(c_sim | Ib) - log p(c_sim | If)``
    is a proper Hastings correction, so there are no hard rejections.
    """
    start = _oriented_start(q, v, g, lp, xi)
    fw, i_f, igr_f, n_eval_f = _forward_search(
        target, start, h0, h_macro, delta, inv_mass, cfg, leapfrog_step,
        "energy", active)

    # `key` is either a PRNG key (draw the refinement coin here) or a
    # pre-drawn uniform in [0,1) of h0's shape (the streaming engine's
    # rng="hash" mode supplies per-chain counter-hash uniforms so a
    # chain's stream never depends on batch composition)
    if (isinstance(key, jnp.ndarray)
            and jnp.issubdtype(key.dtype, jnp.floating)):
        u_coin = key
    else:
        u_coin = jax.random.uniform(key, h0.shape)
    coarse = u_coin < cfg.r2p_prob0
    c_fine = i_f + 1
    nsteps_x = jnp.where(active & ~coarse, _pow2(c_fine), 0)
    h_micro_x = h_macro / _pow2(c_fine).astype(h_macro.dtype)
    trial_x = masked_multistep(target, start, h0, h_micro_x, nsteps_x,
                               inv_mass, leapfrog_step)
    taken = tree_where(coarse, fw, trial_x)
    igr = jnp.where(coarse, igr_f, _igr(h_micro_x, trial_x.max_dh))
    n_eval_f = n_eval_f + trial_x.n_evals
    c_sim = jnp.where(coarse, i_f, c_fine)

    max_try = jnp.where(coarse, i_f - 1, cfg.max_c)
    default_ib = jnp.where(coarse, i_f, cfg.max_c)
    bw_active = active & (max_try >= cfg.min_c)
    i_b, n_eval_b = _backward_search(
        target, taken.state, taken.h_end, h_macro, delta, inv_mass, cfg,
        leapfrog_step, "energy", max_try, default_ib, bw_active)

    log_p0 = math.log(cfg.r2p_prob0)
    log_p1 = math.log(1.0 - cfg.r2p_prob0)
    lwt_f = jnp.where(coarse, log_p0, log_p1)
    lwt_b = jnp.where(
        c_sim == i_b, log_p0,
        jnp.where(c_sim == i_b + 1, log_p1, LOG_ZERO),
    )
    lwt = (lwt_b - lwt_f).astype(h0.dtype)
    return _finish(start, taken.state, xi, taken.h_end, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, c_sim, lwt, igr)


def _rescaled_sweep(target, q_from, g_from, v_from, h_macro, h0_ref, delta,
                    thresh, cfg, active, sred_match=None):
    """One direction of the per-coordinate rescaled-leapfrog search
    (``adaptiveIntegrators.py:660-762``): repeat a single leapfrog step
    in coordinates ``q / Sd`` with ``Sd = 2^{-Sred}``, escalating
    ``Sred`` per coordinate where the mean rescaled gradient magnitude
    exceeds ``thresh``, or globally on non-finite / over-tolerance
    energy error, until the step is accepted.

    When ``sred_match`` is given (backward pass), also stop as soon as
    ``Sred`` equals the forward pass's vector (reference ``:745-748``,
    which sets ``Ib = c + 1`` in that case)."""
    C, D = q_from.shape
    dtype = q_from.dtype
    zeros_i = jnp.zeros((C,), jnp.int32)
    sred0 = jnp.zeros((C, D), jnp.int32)
    init_state = (PhasePoint(q_from, v_from, g_from,
                             jnp.zeros((C,), dtype)),
                  jnp.full((C,), jnp.inf, dtype))

    def cond(carry):
        c, done, *_ = carry
        return (c <= cfg.max_c) & jnp.any(~done)

    def body(carry):
        c, done, sred, out_state, out_h, i_acc, neval = carry
        sd = jnp.exp2(-sred.astype(dtype))
        h = h_macro[:, None]
        gb = sd * g_from
        vh = v_from + 0.5 * h * gb
        qbn = q_from / sd + h * vh
        q1 = qbn * sd
        lp1, g1 = target.logp_grad(q1)
        gb1 = sd * g1
        v1 = vh + 0.5 * h * gb1
        ham1 = -lp1 + 0.5 * jnp.sum(v1 * v1, axis=-1)
        gb_mean = 0.5 * (jnp.abs(gb) + jnp.abs(gb1))

        finite = jnp.isfinite(ham1)
        too_big = gb_mean > thresh
        any_big = jnp.any(too_big, axis=-1)
        e_bad = jnp.abs(h0_ref - ham1) > delta
        accept = finite & ~any_big & ~e_bad

        # at max_c the trial is kept regardless, like the reference's
        # fall-through (qOut = last q1 when the loop never breaks)
        take = ~done & (accept | (c == cfg.max_c))
        out_state, out_h = tree_where(
            take, (PhasePoint(q1, v1, g1, lp1), ham1),
            (out_state, out_h))
        i_acc = jnp.where(~done & accept, c, i_acc)
        neval = neval + (~done).astype(jnp.int32)

        # escalation (order matters: non-finite beats per-coordinate)
        bump_all = ~finite | (finite & ~any_big & e_bad)
        sred_new = jnp.where(
            bump_all[:, None], sred + 1,
            jnp.where((finite & any_big)[:, None] & too_big, sred + 1, sred))
        done_new = done | take
        if sred_match is not None:
            matched = ~done_new & jnp.all(sred_new == sred_match, axis=-1)
            i_acc = jnp.where(matched, c + 1, i_acc)
            done_new = done_new | matched
        sred = jnp.where(done[:, None], sred, sred_new)
        return (c + 1, done_new, sred, out_state, out_h, i_acc, neval)

    init = (jnp.zeros((), jnp.int32), ~active, sred0, init_state[0],
            init_state[1], jnp.full((C,), cfg.max_c, jnp.int32), zeros_i)
    (_, _, sred, state, h_end, i_acc, neval) = jax.lax.while_loop(
        cond, body, init)
    return state, h_end, sred, i_acc, neval


def adapt_rescaled_leapfrog_d(key, target, q, v, g, lp, h0, h_macro, xi,
                              delta, inv_mass, active, cfg):
    """Experimental per-coordinate step rescaling
    (``adaptiveIntegrators.py:660-762``).  Reversibility compares the
    forward and backward ``Sred`` vectors; mismatch weights the state
    to log-zero.  The diagonal inverse mass is ignored, as in the
    reference (identity-metric WALNUTSpy convention)."""
    del inv_mass  # identity metric, as in the reference
    start = _oriented_start(q, v, g, lp, xi)
    thresh = cfg.rescaled_grad_thresh
    fw_state, fw_h, sred_f, i_f, n_eval_f = _rescaled_sweep(
        target, start.q, start.g, start.v, h_macro, h0, delta, thresh, cfg,
        active)

    bw_active = active & (i_f > 0)
    bw_state, bw_h, sred_b, i_b0, n_eval_b = _rescaled_sweep(
        target, fw_state.q, fw_state.g, -fw_state.v, h_macro, fw_h, delta,
        thresh, cfg, bw_active, sred_match=sred_f)
    i_b = jnp.where(i_f > 0, i_b0, i_f)
    sred_b = jnp.where(bw_active[:, None], sred_b, sred_f)

    mismatch = jnp.any(sred_b != sred_f, axis=-1)
    lwt = jnp.where(mismatch, LOG_ZERO, 0.0).astype(h0.dtype)
    igr = jnp.ones_like(h0)
    return _finish(start, fw_state, xi, fw_h, active, lp, h0,
                   n_eval_f, n_eval_b, i_f, i_b, i_f, lwt, igr)


INTEGRATORS = {
    "fixed_leapfrog": fixed_leapfrog,
    "adapt_leapfrog_d": adapt_leapfrog_d,
    "adapt_yoshida_d": adapt_yoshida_d,
    "adapt_leapfrog_flow_d": adapt_leapfrog_flow_d,
    "adapt_leapfrog_r2p": adapt_leapfrog_r2p,
    "adapt_implicit_midpoint_d": adapt_implicit_midpoint_d,
    "adapt_rescaled_leapfrog_d": adapt_rescaled_leapfrog_d,
}


def get_integrator(name):
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; available: {sorted(INTEGRATORS)}"
        ) from None
