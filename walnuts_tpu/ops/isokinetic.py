"""Isokinetic (microcanonical) dynamics — batched over chains.

Re-designs the reference's isokinetic research line
(``isokinetic/microCanonical.py:16-316``, MATLAB twin
``isokinetic/walnuts_imc/bab_isokinetic.m:1-50``) as fixed-shape
masked chain-batch programs:

* the state carries a *unit-sphere* velocity ``u`` (``MCstate``,
  ``microCanonical.py:16-48``);
* one micro step is the exact B(h/2)-A(h)-B(h/2) splitting whose
  B-kick is the closed-form isokinetic flow along the score direction
  (``cosh``/``sinh`` with normaliser ``Z``), accumulating the
  log-Jacobian ``W += (d-1) log Z`` (``microCanonical.py:69-127``);
* numerical guards: ``delta > DELTA_THRESH`` and ``Z < 1e-14`` poison
  the chain's step (the reference returns ``badMCState`` NaN states,
  ``microCanonical.py:51-55,82,92``) — here they clear a per-chain
  ``ok`` flag so the orbit layer treats the state as weight-dead;
* ``adapt_mc_step_e`` is the halving search on the *modified* energy
  ``|-H_new - W + H_old| < delta`` with a backward ``Ib`` pass and
  weight ``-W`` plus a hard log-zero rejection when ``Ib < If``
  (``microCanonical.py:266-316``).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import LOG_ZERO, ISOKINETIC_DELTA_THRESH


class MCState(NamedTuple):
    """Batched isokinetic phase point: unit velocity, cached density."""

    q: jnp.ndarray    # [C, D]
    u: jnp.ndarray    # [C, D], ||u|| = 1 per chain
    g: jnp.ndarray    # [C, D]
    lp: jnp.ndarray   # [C]

    @property
    def ham(self):
        """Isokinetic 'Hamiltonian' is just -logp
        (``microCanonical.py:26``)."""
        return -self.lp


class StepStats(NamedTuple):
    """Per-macro-step diagnostics of an adaptive step kernel (the
    reference accumulates these in Python lists,
    ``microCanonical.py:227-254``)."""

    n_evals: jnp.ndarray     # [C] int32
    i_f: jnp.ndarray         # [C] int32
    i_b: jnp.ndarray         # [C] int32
    energy_err: jnp.ndarray  # [C] signed modified-energy error
    c_obs: jnp.ndarray       # [C] |err| * nstep^2 / h^3 (warmup stat)
    basic: jnp.ndarray       # [C] bool: If == c_min (no backward pass)


def refresh_u(key, shape, dtype=jnp.float32):
    """Full momentum refresh: u uniform on the unit sphere
    (``microCanonical.py:30-32``)."""
    p = jax.random.normal(key, shape, dtype)
    return p / jnp.linalg.norm(p, axis=-1, keepdims=True)


def partial_refresh_u(key, u, c1):
    """Partial refresh mixing the old direction with a fresh normal
    draw (``microCanonical.py:34-38``)."""
    z = jax.random.normal(key, u.shape, u.dtype)
    z = z / jnp.sqrt(jnp.asarray(u.shape[-1], u.dtype))
    t = c1 * u + jnp.sqrt(1.0 - c1**2) * z
    return t / jnp.linalg.norm(t, axis=-1, keepdims=True)


def _b_kick(u, g, h_half, d):
    """Exact isokinetic B-kick over time ``h_half`` along the score
    direction; returns ``(u_new, dW, ok)``
    (``microCanonical.py:81-95``; ``bab_isokinetic.m:12-28``)."""
    gnorm = jnp.linalg.norm(g, axis=-1)
    delta = h_half * gnorm / (d - 1.0)
    ok = delta <= ISOKINETIC_DELTA_THRESH
    delta = jnp.clip(delta, 0.0, ISOKINETIC_DELTA_THRESH)  # keep cosh finite
    e = g / jnp.maximum(gnorm, 1e-300)[:, None]
    ep = jnp.sum(e * u, axis=-1)
    ch, sh = jnp.cosh(delta), jnp.sinh(delta)
    z = ch + ep * sh
    ok = ok & (z >= 1.0e-14)
    zs = jnp.maximum(z, 1.0e-14)
    d_w = (d - 1.0) * jnp.log(zs)
    u_new = u / zs[:, None] + ((sh + ep * (ch - 1.0)) / zs)[:, None] * e
    # re-project onto the sphere against roundoff (``bab_isokinetic.m:47``)
    u_new = u_new / jnp.linalg.norm(u_new, axis=-1, keepdims=True)
    return u_new, d_w, ok


class IsoMultistepResult(NamedTuple):
    state: MCState
    log_jac: jnp.ndarray    # [C] accumulated W
    all_ok: jnp.ndarray     # [C] bool
    n_evals: jnp.ndarray    # [C] int32


def isokinetic_multistep(target, state: MCState, h_micro, nsteps):
    """Advance each chain ``nsteps[c]`` B-A-B micro steps of size
    ``h_micro[c]``, accumulating the log-Jacobian ``W``
    (``microCanonical.py:69-127``).  Chains with ``nsteps == 0`` pass
    through untouched; guard violations clear ``all_ok``.
    """
    d = jnp.asarray(state.q.shape[-1], state.q.dtype)

    def cond(carry):
        k, *_ = carry
        return jnp.any(k < nsteps)

    def body(carry):
        k, s, w, all_ok, nev = carry
        active = k < nsteps
        hh = jnp.where(active, h_micro, 0.0)
        h_half = 0.5 * hh

        u1, dw1, ok1 = _b_kick(s.u, s.g, h_half, d)
        q2 = s.q + hh[:, None] * u1
        lp2, g2 = target.logp_grad(q2)
        u2, dw2, ok2 = _b_kick(u1, g2, h_half, d)

        ok = ok1 & ok2 & jnp.isfinite(lp2)
        a1 = active[:, None]
        s_out = MCState(
            q=jnp.where(a1, q2, s.q),
            u=jnp.where(a1, u2, s.u),
            g=jnp.where(a1, g2, s.g),
            lp=jnp.where(active, lp2, s.lp),
        )
        w = w + jnp.where(active, dw1 + dw2, 0.0)
        all_ok = jnp.where(active, all_ok & ok, all_ok)
        nev = nev + active.astype(jnp.int32)
        return (k + 1, s_out, w, all_ok, nev)

    C = state.lp.shape[0]
    init = (jnp.zeros((), jnp.int32), state,
            jnp.zeros((C,), state.q.dtype), jnp.ones((C,), bool),
            jnp.zeros((C,), jnp.int32))
    _, s, w, all_ok, nev = jax.lax.while_loop(cond, body, init)
    return IsoMultistepResult(s, w, all_ok, nev)


def isokinetic_multistep_err(target, state: MCState, h_micro, nsteps):
    """B-A-B multistep with the per-step Euler-comparison flow-error
    estimate (``integrateSplittingErrEst``,
    ``microCanonical.py:129-215``): each step accumulates the
    elementwise max of forward and backward Euler reconstruction
    discrepancies in position and velocity; the scalar error is the
    max over coordinates of the accumulated sums.

    Returns ``(IsoMultistepResult, err_est)``.
    """
    d = jnp.asarray(state.q.shape[-1], state.q.dtype)

    def cond(carry):
        k, *_ = carry
        return jnp.any(k < nsteps)

    def body(carry):
        k, s, w, all_ok, nev, eq, eu = carry
        active = k < nsteps
        hh = jnp.where(active, h_micro, 0.0)
        h1 = hh[:, None]
        h_half = 0.5 * hh

        # forward Euler references (``microCanonical.py:148-152``)
        gu = jnp.sum(s.g * s.u, axis=-1)[:, None]
        eul_q = s.q + h1 * s.u
        eul_u = s.u + (h1 / (d - 1.0)) * (s.g - gu * s.u)
        eul_u = eul_u / jnp.linalg.norm(eul_u, axis=-1, keepdims=True)

        u1, dw1, ok1 = _b_kick(s.u, s.g, h_half, d)
        q2 = s.q + h1 * u1
        lp2, g2 = target.logp_grad(q2)
        u2, dw2, ok2 = _b_kick(u1, g2, h_half, d)
        ok = ok1 & ok2 & jnp.isfinite(lp2)

        # error contributions (``microCanonical.py:186-199``)
        err_qf = jnp.abs(q2 - eul_q)
        err_uf = jnp.abs(u2 - eul_u)
        err_qb = jnp.abs(s.q - (q2 - h1 * u2))
        gu2 = jnp.sum(g2 * u2, axis=-1)[:, None]
        uback = -u2 + (h1 / (d - 1.0)) * (g2 - gu2 * u2)
        uback = uback / jnp.linalg.norm(uback, axis=-1, keepdims=True)
        err_ub = jnp.abs(-s.u - uback)

        a1 = active[:, None]
        eq = eq + jnp.where(a1, jnp.maximum(err_qf, err_qb), 0.0)
        eu = eu + jnp.where(a1, jnp.maximum(err_uf, err_ub), 0.0)

        s_out = MCState(
            q=jnp.where(a1, q2, s.q),
            u=jnp.where(a1, u2, s.u),
            g=jnp.where(a1, g2, s.g),
            lp=jnp.where(active, lp2, s.lp),
        )
        w = w + jnp.where(active, dw1 + dw2, 0.0)
        all_ok = jnp.where(active, all_ok & ok, all_ok)
        nev = nev + active.astype(jnp.int32)
        return (k + 1, s_out, w, all_ok, nev, eq, eu)

    C = state.lp.shape[0]
    dtype = state.q.dtype
    zq = jnp.zeros_like(state.q)
    init = (jnp.zeros((), jnp.int32), state, jnp.zeros((C,), dtype),
            jnp.ones((C,), bool), jnp.zeros((C,), jnp.int32), zq, zq)
    _, s, w, all_ok, nev, eq, eu = jax.lax.while_loop(cond, body, init)
    err = jnp.maximum(jnp.max(eq, axis=-1), jnp.max(eu, axis=-1))
    return IsoMultistepResult(s, w, all_ok, nev), err


def _pow2(c):
    return jnp.left_shift(jnp.ones((), jnp.int32), c)


def fixed_mc_step(key, target, state: MCState, h_macro, delta, active,
                  c_min=0, c_max=10):
    """Single B-A-B step, no adaptation (``fixedMCstep``,
    ``microCanonical.py:219-221``)."""
    del key, delta, c_min, c_max
    nsteps = jnp.where(active, 1, 0)
    r = isokinetic_multistep(target, state, h_macro, nsteps)
    lwt = jnp.where(r.all_ok, -r.log_jac, LOG_ZERO)
    zi = jnp.zeros_like(r.n_evals)
    stats = StepStats(r.n_evals, zi, zi,
                      jnp.zeros_like(h_macro), jnp.zeros_like(h_macro),
                      jnp.ones(active.shape, bool))
    return r.state, lwt, stats


def adapt_mc_step_flow2(key, target, state: MCState, h_macro, delta, active,
                        c_min=0, c_max=10):
    """Flow-error halving search using the Euler-comparison estimate
    (``adaptMCstepFlow2``, ``microCanonical.py:466-562``): the first
    refinement whose accumulated flow-error estimate is below ``delta``
    is ``If``; the backward pass searches ``c_min..If`` *inclusive*
    from the flipped endpoint; weight ``-W`` with a hard ``LOG_ZERO``
    when ``Ib < If``."""
    del key
    C = state.lp.shape[0]
    dtype = state.q.dtype
    ham0 = state.ham

    def fwd_cond(carry):
        c, done, *_ = carry
        return (c <= c_max) & jnp.any(~done)

    def fwd_body(carry):
        c, done, out, w_out, ok_out, i_f, e_acc, cobs, nev = carry
        nsteps = jnp.where(done, 0, _pow2(c))
        h_micro = h_macro / _pow2(c).astype(dtype)
        r, err = isokinetic_multistep_err(target, state, h_micro, nsteps)
        loc_acc = -r.state.ham - r.log_jac + ham0
        n_f = _pow2(c).astype(dtype)
        accept = r.all_ok & (err < delta)
        take = ~done & (accept | (c == c_max))
        sel = take[:, None]
        out = MCState(
            q=jnp.where(sel, r.state.q, out.q),
            u=jnp.where(sel, r.state.u, out.u),
            g=jnp.where(sel, r.state.g, out.g),
            lp=jnp.where(take, r.state.lp, out.lp),
        )
        w_out = jnp.where(take, r.log_jac, w_out)
        ok_out = jnp.where(take, r.all_ok, ok_out)
        i_f = jnp.where(take, c, i_f)
        e_acc = jnp.where(take, loc_acc, e_acc)
        cobs = jnp.where(take, jnp.abs(loc_acc) * n_f**2 / h_macro**3, cobs)
        nev = nev + r.n_evals
        return (c + 1, done | take, out, w_out, ok_out, i_f, e_acc, cobs,
                nev)

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    init = (jnp.asarray(c_min, jnp.int32), ~active, state, zf,
            jnp.ones((C,), bool), zi, zf, zf, zi)
    (_, _, out, w_out, ok_out, i_f, err_acc, cobs, nev_f) = \
        jax.lax.while_loop(fwd_cond, fwd_body, init)

    state_b = MCState(out.q, -out.u, out.g, out.lp)
    bw_active = active & (i_f > c_min)
    max_try = i_f  # inclusive upper bound (``microCanonical.py:527``)

    def bwd_cond(carry):
        c, found, *_ = carry
        return jnp.any(~found & (c <= max_try))

    def bwd_body(carry):
        c, found, i_b, nev = carry
        do = ~found & (c <= max_try)
        nsteps = jnp.where(do, _pow2(c), 0)
        h_micro = h_macro / _pow2(c).astype(dtype)
        r, err = isokinetic_multistep_err(target, state_b, h_micro, nsteps)
        accept = do & r.all_ok & (err < delta)
        i_b = jnp.where(accept, c, i_b)
        nev = nev + r.n_evals
        return (c + 1, found | accept, i_b, nev)

    init_b = (jnp.asarray(c_min, jnp.int32), ~bw_active, i_f,
              jnp.zeros((C,), jnp.int32))
    _, _, i_b, nev_b = jax.lax.while_loop(bwd_cond, bwd_body, init_b)

    lwt = -w_out + jnp.where(i_b < i_f, LOG_ZERO, 0.0)
    lwt = jnp.where(ok_out, lwt, LOG_ZERO)
    lwt = jnp.where(active, lwt, 0.0)
    stats = StepStats(
        n_evals=jnp.where(active, nev_f + nev_b, 0),
        i_f=jnp.where(active, i_f, 0),
        i_b=jnp.where(active, i_b, 0),
        energy_err=jnp.where(active, err_acc, 0.0),
        c_obs=jnp.where(active, cobs, 0.0),
        basic=active & (i_f == c_min),
    )
    out = MCState(
        q=jnp.where(active[:, None], out.q, state.q),
        u=jnp.where(active[:, None], out.u, state.u),
        g=jnp.where(active[:, None], out.g, state.g),
        lp=jnp.where(active, out.lp, state.lp),
    )
    return out, lwt, stats


def adapt_mc_step_e(key, target, state: MCState, h_macro, delta, active,
                    c_min=0, c_max=10):
    """Energy-error halving search over the isokinetic integrator
    (``adaptMCstepE.__call__``, ``microCanonical.py:266-316``).

    Returns ``(new_state, lwt, stats)`` where ``lwt = -W`` plus a hard
    ``LOG_ZERO`` when the backward minimal refinement ``Ib`` is below
    the forward one.
    """
    del key
    C = state.lp.shape[0]
    dtype = state.q.dtype
    ham0 = state.ham

    def fwd_cond(carry):
        c, done, *_ = carry
        return (c <= c_max) & jnp.any(~done)

    def fwd_body(carry):
        c, done, out, w_out, ok_out, i_f, err, cobs, nev = carry
        nsteps = jnp.where(done, 0, _pow2(c))
        h_micro = h_macro / _pow2(c).astype(dtype)
        r = isokinetic_multistep(target, state, h_micro, nsteps)
        loc_acc = -r.state.ham - r.log_jac + ham0
        n_f = _pow2(c).astype(dtype)
        accept = r.all_ok & (jnp.abs(loc_acc) < delta)
        take = ~done & (accept | (c == c_max))
        sel = take[:, None]
        out = MCState(
            q=jnp.where(sel, r.state.q, out.q),
            u=jnp.where(sel, r.state.u, out.u),
            g=jnp.where(sel, r.state.g, out.g),
            lp=jnp.where(take, r.state.lp, out.lp),
        )
        w_out = jnp.where(take, r.log_jac, w_out)
        ok_out = jnp.where(take, r.all_ok, ok_out)
        i_f = jnp.where(take, c, i_f)
        err = jnp.where(take, loc_acc, err)
        cobs = jnp.where(
            take, jnp.abs(loc_acc) * n_f**2 / h_macro**3, cobs)
        nev = nev + r.n_evals
        return (c + 1, done | take, out, w_out, ok_out, i_f, err, cobs, nev)

    zf = jnp.zeros((C,), dtype)
    zi = jnp.zeros((C,), jnp.int32)
    init = (jnp.asarray(c_min, jnp.int32), ~active, state, zf,
            jnp.ones((C,), bool), zi, zf, zf, zi)
    (_, _, out, w_out, ok_out, i_f, err, cobs, nev_f) = jax.lax.while_loop(
        fwd_cond, fwd_body, init)

    # backward pass from the flipped endpoint (``microCanonical.py:288-307``)
    ham_b0 = out.ham
    state_b = MCState(out.q, -out.u, out.g, out.lp)
    bw_active = active & (i_f > c_min)
    max_try = i_f - 1

    def bwd_cond(carry):
        c, found, *_ = carry
        return jnp.any(~found & (c <= max_try))

    def bwd_body(carry):
        c, found, i_b, nev = carry
        do = ~found & (c <= max_try)
        nsteps = jnp.where(do, _pow2(c), 0)
        h_micro = h_macro / _pow2(c).astype(dtype)
        r = isokinetic_multistep(target, state_b, h_micro, nsteps)
        loc_acc = -r.state.ham - r.log_jac + ham_b0
        accept = do & r.all_ok & (jnp.abs(loc_acc) < delta)
        i_b = jnp.where(accept, c, i_b)
        nev = nev + r.n_evals
        return (c + 1, found | accept, i_b, nev)

    init_b = (jnp.asarray(c_min, jnp.int32), ~bw_active, i_f,
              jnp.zeros((C,), jnp.int32))
    _, _, i_b, nev_b = jax.lax.while_loop(bwd_cond, bwd_body, init_b)

    lwt = -w_out + jnp.where(i_b < i_f, LOG_ZERO, 0.0)
    lwt = jnp.where(ok_out, lwt, LOG_ZERO)
    lwt = jnp.where(active, lwt, 0.0)
    stats = StepStats(
        n_evals=jnp.where(active, nev_f + nev_b, 0),
        i_f=jnp.where(active, i_f, 0),
        i_b=jnp.where(active, i_b, 0),
        energy_err=jnp.where(active, err, 0.0),
        c_obs=jnp.where(active, cobs, 0.0),
        basic=active & (i_f == c_min),
    )
    out = MCState(
        q=jnp.where(active[:, None], out.q, state.q),
        u=jnp.where(active[:, None], out.u, state.u),
        g=jnp.where(active[:, None], out.g, state.g),
        lp=jnp.where(active, out.lp, state.lp),
    )
    return out, lwt, stats
