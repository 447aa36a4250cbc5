"""Masked multi-step symplectic integration — the engine's hot loop.

The reference advances one chain at a time through Python ``for`` loops
of leapfrog micro steps (``WALNUTSpy/adaptiveIntegrators.py:78-84``,
``walnuts/walnuts.py:74-95``).  Here the same dynamics run as a single
``lax.while_loop`` over an entire chain batch ``[C, D]``: each
iteration performs **one batched gradient evaluation** for every chain
that still has micro steps remaining, with per-chain step counts and
per-chain micro step sizes.  Chains whose counter hit zero ride along
masked — this is the fixed-shape execution model that keeps the device
busy while chains disagree about how much refinement they need.

Energy bookkeeping is streaming: instead of materialising the
``Hams[0..n]`` array the reference builds per macro step
(``adaptiveIntegrators.py:75``), we carry the running endpoint energy,
the running max consecutive energy jump (feeds the third-order step
size model ``igrConst``, ``adaptiveIntegrators.py:101``), a running
max per-step flow error (for the Flow criteria,
``adaptiveIntegrators.py:246-356``), and an all-finite flag.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .hamiltonian import hamiltonian

# 4th-order Yoshida composition coefficients
# (reference ``adaptiveIntegrators.py:143-144``).
YOSHIDA_W1 = 1.351207191959658
YOSHIDA_W2 = -1.702414383919315


class PhasePoint(NamedTuple):
    """A batch of phase-space points in integration orientation."""

    q: jnp.ndarray     # [C, D] position
    v: jnp.ndarray     # [C, D] velocity (already xi-oriented)
    g: jnp.ndarray     # [C, D] gradient of logp at q
    lp: jnp.ndarray    # [C]    logp at q


class MultistepResult(NamedTuple):
    state: PhasePoint
    h_end: jnp.ndarray        # [C] Hamiltonian at the final state
    max_dh: jnp.ndarray       # [C] max |H_k - H_{k-1}| over executed steps
    max_step_err: jnp.ndarray  # [C] max per-step flow-error estimate
    all_finite: jnp.ndarray   # [C] bool: finite energies AND every step ok
    n_evals: jnp.ndarray      # [C] int32 gradient evals actually performed


def leapfrog_step(target, state: PhasePoint, hh, inv_mass=None):
    """One velocity-Verlet micro step; one gradient evaluation.

    ``hh`` is per-chain ``[C]``.  (Reference kernel:
    ``adaptiveIntegrators.py:78-84``.)

    Step functions return ``(state, err, ok, nev)`` where ``err`` is a
    per-step flow-error estimate, ``ok`` flags per-chain step success
    (always true for explicit steps), and ``nev`` counts per-chain
    gradient evaluations (int or ``[C]`` array).
    """
    h = hh[:, None]
    vh = state.v + 0.5 * h * state.g
    dq = vh if inv_mass is None else inv_mass * vh
    q2 = state.q + h * dq
    lp2, g2 = target.logp_grad(q2)
    v2 = vh + 0.5 * h * g2
    err = jnp.zeros_like(hh)
    ok = jnp.ones(hh.shape, bool)
    return PhasePoint(q2, v2, g2, lp2), err, ok, 1


def yoshida_step(target, state: PhasePoint, hh, inv_mass=None):
    """One 4th-order 3-stage Yoshida step; three gradient evaluations
    (reference ``adaptiveIntegrators.py:156-175``)."""
    s = state
    for w in (YOSHIDA_W1, YOSHIDA_W2, YOSHIDA_W1):
        s, _, _, _ = leapfrog_step(target, s, w * hh, inv_mass)
    return s, jnp.zeros_like(hh), jnp.ones(hh.shape, bool), 3


def leapfrog_flow_step(target, state: PhasePoint, hh, inv_mass=None):
    """Leapfrog step plus Hermite forward/backward flow-error estimate.

    Two gradient evaluations per step: one at the endpoint, one at the
    reconstructed midpoint (reference ``adaptiveIntegrators.py:260-287``).
    The error is the max-norm discrepancy between the leapfrog update
    and 4th-order Hermite reconstructions in both directions.
    """
    h = hh[:, None]
    q_old, v_old, g_old = state.q, state.v, state.g
    new, _, _, _ = leapfrog_step(target, state, hh, inv_mass)
    q2, v2, g2 = new.q, new.v, new.g

    q_mid = 0.5 * (q2 + q_old) + (h / 8.0) * (v_old - v2)
    _, g_mid = target.logp_grad(q_mid)

    qf = q_old + h * v_old + h * h * (g_old / 6.0 + g_mid / 3.0)
    err = jnp.max(jnp.abs(qf - q2), axis=-1)
    vf = v_old + (h / 6.0) * (g_old + g2 + 4.0 * g_mid)
    err = jnp.maximum(err, jnp.max(jnp.abs(vf - v2), axis=-1))
    qb = q2 - h * v2 + h * h * (g2 / 6.0 + g_mid / 3.0)
    err = jnp.maximum(err, jnp.max(jnp.abs(qb - q_old), axis=-1))
    vb = -(-v2 + (h / 6.0) * (g_old + g2 + 4.0 * g_mid))
    err = jnp.maximum(err, jnp.max(jnp.abs(vb - v_old), axis=-1))
    return new, err, jnp.ones(hh.shape, bool), 2


def implicit_midpoint_step(target, state: PhasePoint, hh, inv_mass=None, *,
                           fp_tol=1.0e-8, max_fp_iter=30, newton=False):
    """One implicit-midpoint micro step solved by fixed-point (or
    Newton) iteration (reference ``adaptiveIntegrators.py:492-540``).

    The update solves ``q2 = q + h v + (h^2/2) M^{-1} g((q + q2)/2)``
    from a leapfrog initial guess.  Iteration stops per chain on
    convergence (``max|dq| < fp_tol``) or divergence
    (``err > 1.1 * prev_err``, reference ``:521-524``).  A chain whose
    step fails returns ``ok=False`` and a ``-inf`` density so the
    orbit layer records a forced rejection instead of the reference's
    ``sys.exit`` (deviation noted in SURVEY §7.4).

    Newton mode (``auxPar.FPNewton``, reference ``:503-506``) uses the
    batched target Hessian and a dense solve per iteration.
    """
    h = hh[:, None]
    qq, vv, gg = state.q, state.v, state.g
    scale = 1.0 if inv_mass is None else inv_mass
    base = qq + h * (scale * vv)
    qt0 = base + 0.5 * h * h * (scale * gg)  # leapfrog guess
    big = jnp.full(hh.shape, 1.0e30, hh.dtype)
    # the reference's 1e-8 default tolerance is unreachable in float32
    # (eps ~ 1.2e-7): floor it at 32 ulp of the working dtype scaled by
    # the position magnitude, so f32 chains can converge
    eps = jnp.finfo(qq.dtype).eps
    q_mag = jnp.maximum(jnp.max(jnp.abs(qq), axis=-1), 1.0)
    fp_tol = jnp.maximum(jnp.asarray(fp_tol, qq.dtype), 32.0 * eps * q_mag)

    def cond(carry):
        it, qt, done, conv, old_err, nev = carry
        return (it < max_fp_iter) & jnp.any(~done)

    def body(carry):
        it, qt, done, conv, old_err, nev = carry
        mid = 0.5 * (qt + qq)
        if newton:
            hess = target.hessian_batched(mid)
            gmp = target.logp_grad(mid)[1]
            d = qq.shape[-1]
            eye = jnp.eye(d, dtype=qt.dtype)
            hh2 = (0.25 * h * h)[..., None] * (
                hess if inv_mass is None else inv_mass[:, None] * hess
            ) - eye
            resid = base + 0.5 * h * h * (scale * gmp) - qt
            qt_new = qt - jnp.linalg.solve(hh2, resid[..., None])[..., 0]
        else:
            gmp = target.logp_grad(mid)[1]
            qt_new = base + 0.5 * h * h * (scale * gmp)
        err = jnp.max(jnp.abs(qt_new - qt), axis=-1)
        qt = jnp.where(done[:, None], qt, qt_new)
        newly_conv = ~done & (err < fp_tol)
        diverged = ~done & (err > 1.1 * old_err)
        conv = conv | newly_conv
        old_err = jnp.where(done, old_err, err)
        nev = nev + (~done).astype(jnp.int32)
        done = done | newly_conv | diverged
        return (it + 1, qt, done, conv, old_err, nev)

    init = (jnp.zeros((), jnp.int32), qt0,
            jnp.zeros(hh.shape, bool), jnp.zeros(hh.shape, bool), big,
            jnp.zeros(hh.shape, jnp.int32))
    _, qt, _, conv, _, nev = jax.lax.while_loop(cond, body, init)

    # final midpoint evaluation at the converged qt, then the update
    # (reference ``adaptiveIntegrators.py:528-540``)
    mid = 0.5 * (qt + qq)
    gmp = target.logp_grad(mid)[1]
    q2 = base + 0.5 * h * h * (scale * gmp)
    v2 = vv + h * gmp
    lp2, g2 = target.logp_grad(q2)
    lp2 = jnp.where(conv, lp2, -jnp.inf)
    return (PhasePoint(q2, v2, g2, lp2), jnp.zeros_like(hh), conv, nev + 2)


STEP_FNS = {
    "leapfrog": leapfrog_step,
    "yoshida": yoshida_step,
    "leapfrog_flow": leapfrog_flow_step,
    "implicit_midpoint": implicit_midpoint_step,
}


def masked_multistep(
    target,
    state: PhasePoint,
    h0_energy,
    h_micro,
    nsteps,
    inv_mass=None,
    step_fn=leapfrog_step,
):
    """Advance each chain ``nsteps[c]`` micro steps of size ``h_micro[c]``.

    Runs ``max(nsteps)`` batched iterations; chains with fewer steps
    freeze in place once their counter is exhausted.  ``nsteps == 0``
    chains pass through untouched (they still occupy lanes in the
    shared gradient evaluations — the cost of fixed-shape execution).
    """
    def cond(carry):
        k, *_ = carry
        return jnp.any(k < nsteps)

    def body(carry):
        k, s, h_end, max_dh, max_err, finite, nev = carry
        active = k < nsteps
        s_new, err, ok, nev_k = step_fn(
            target, s, jnp.where(active, h_micro, 0.0), inv_mass)
        h_new = hamiltonian(s_new.lp, s_new.v, inv_mass)
        dh = jnp.abs(h_new - h_end)
        a1 = active[:, None]
        s_out = PhasePoint(
            q=jnp.where(a1, s_new.q, s.q),
            v=jnp.where(a1, s_new.v, s.v),
            g=jnp.where(a1, s_new.g, s.g),
            lp=jnp.where(active, s_new.lp, s.lp),
        )
        h_end = jnp.where(active, h_new, h_end)
        max_dh = jnp.where(active, jnp.maximum(max_dh, dh), max_dh)
        max_err = jnp.where(active, jnp.maximum(max_err, err), max_err)
        finite = jnp.where(active, finite & ok & jnp.isfinite(h_new), finite)
        nev = nev + jnp.where(active, nev_k, 0)
        return (k + 1, s_out, h_end, max_dh, max_err, finite, nev)

    zeros = jnp.zeros_like(h0_energy)
    init = (
        jnp.zeros((), jnp.int32),
        state,
        h0_energy,
        zeros,
        zeros,
        jnp.ones(h0_energy.shape, bool),
        jnp.zeros(h0_energy.shape, jnp.int32),
    )
    (_, s, h_end, max_dh, max_err, finite, nev) = jax.lax.while_loop(
        cond, body, init)
    return MultistepResult(s, h_end, max_dh, max_err, finite, nev)
