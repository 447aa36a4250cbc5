"""Float32 validation (the precision the bench runs in).

The global test harness enables x64 (conftest.py) but every engine
derives its working dtype from ``q0.dtype``, so feeding float32 inputs
exercises the full f32 path the bench uses.  SURVEY §7.3 names f32
energy accumulation on the funnel (``exp(-omega)`` dynamic range) as a
hard part — these are the asserting statistical checks round 1 lacked
(VERDICT "What's weak" #3).
"""

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

import walnuts_tpu as wt
from walnuts_tpu.sampler.megakernel import run_walnuts_fused


def test_f32_funnel_tail_and_moments():
    """Scan engine in f32: funnel-11 omega marginal is N(0, 9) with
    the left tail resolved (P(omega < -3) = 0.1587)."""
    t = wt.targets.funnel(11)
    C = 256
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (C, 11),
                                 jnp.float32)
    assert q0.dtype == jnp.float32
    wu = wt.WarmupConfig(warmup_iter=300, pooled=True)
    samples, diags, state = wt.run_walnuts(
        jax.random.PRNGKey(1), q0, target=t, cfg=wt.WalnutsConfig(m=8),
        warmup=wu, num_iter=1200, h0=0.3, delta0=0.3)
    assert samples.dtype == jnp.float32
    w = np.asarray(samples, np.float64)[301:, :, 0].ravel()
    n_eff = len(w) / 60  # generous autocorrelation allowance
    se_mean = 3.0 / np.sqrt(n_eff)
    assert abs(w.mean()) < 5 * se_mean, w.mean()
    assert abs(w.std() - 3.0) < 5 * 3 * np.sqrt(0.5 / n_eff), w.std()
    tail = (w < -3.0).mean()
    p_exact = stats.norm.cdf(-1.0)
    se_tail = np.sqrt(p_exact * (1 - p_exact) / n_eff)
    assert abs(tail - p_exact) < 5 * se_tail, (tail, p_exact)


def test_f32_megakernel_matches_f64():
    """The megakernel's posterior in f32 matches its own f64 run
    (energy accumulation does not corrupt the invariant measure)."""
    t = wt.targets.funnel(11)
    C = 128
    key = jax.random.PRNGKey(2)
    q64 = 0.1 * jax.random.normal(key, (C, 11), jnp.float64)
    q32 = q64.astype(jnp.float32)
    out = {}
    for tag, q0 in (("f64", q64), ("f32", q32)):
        h = jnp.full((C,), 0.32, q0.dtype)
        dl = jnp.full((C,), 0.34, q0.dtype)
        s, d, qf, cnt, ng = run_walnuts_fused(
            jax.random.PRNGKey(5), q0, h, dl, target=t,
            cfg=wt.WalnutsConfig(m=7), num_iter=600)
        w = np.asarray(s, np.float64)[150:, :, 0].ravel()
        out[tag] = (w.mean(), w.std(), np.asarray(d, np.float64))
    n_eff = 128 * 450 / 50
    # both runs draw from the same posterior within MC error
    assert abs(out["f32"][0] - out["f64"][0]) < 7 * 3 / np.sqrt(n_eff)
    assert abs(out["f32"][1] - out["f64"][1]) < 7 * 3 * np.sqrt(
        0.5 / n_eff)
    # f32 orbit energy errors (diag col 17) stay in the f64 regime:
    # compare median energy error, excluding forced rejects
    e32 = out["f32"][2][..., 17].ravel()
    e64 = out["f64"][2][..., 17].ravel()
    m32 = np.median(e32[np.isfinite(e32)])
    m64 = np.median(e64[np.isfinite(e64)])
    assert abs(m32 - m64) < 0.15 * max(m64, 0.05), (m32, m64)


def test_f32_deep_neck_recovery():
    """Transient from deep in the funnel neck (omega = -10) in f32:
    the step-halving search resolves the e^{10} curvature and chains
    recover to the typical set, matching the f64 run's recovery
    profile (the small-scale analogue of mainFunnelTransient.py's
    omega=-30 start)."""
    t = wt.targets.funnel(11)
    C = 64
    for dtype in (jnp.float32, jnp.float64):
        q0 = jnp.zeros((C, 11), dtype).at[:, 0].set(-10.0)
        q0 = q0 + 0.01 * jax.random.normal(
            jax.random.PRNGKey(3), (C, 11), dtype)
        cfg = wt.WalnutsConfig(
            m=8, igr=wt.IntegratorConfig(max_c=16))
        wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                             adapt_delta=False)
        samples, diags, state = wt.run_walnuts(
            jax.random.PRNGKey(4), q0, target=t, cfg=cfg, warmup=wu,
            num_iter=60, h0=0.3, delta0=0.3)
        w = np.asarray(samples, np.float64)[..., 0]
        assert np.all(np.isfinite(w)), dtype
        # chains must leave the neck: median omega over the last 10
        # iterations is back in the central region
        med_end = np.median(w[-10:])
        assert med_end > -6.0, (dtype, med_end)


def test_f32_energy_accumulation_micro():
    """Direct f32-vs-f64 energy drift check: a 2^10-micro-step macro
    step at moderate funnel depth accumulates the same |dH| in f32 as
    in f64 to ~1e-3 absolute."""
    from walnuts_tpu.ops.hamiltonian import hamiltonian

    t = wt.targets.funnel(11)
    C = 16
    key = jax.random.PRNGKey(9)
    q64 = jax.random.normal(key, (C, 11), jnp.float64)
    q64 = q64.at[:, 0].set(q64[:, 0] * 2.0)
    v64 = jax.random.normal(jax.random.PRNGKey(10), (C, 11),
                            jnp.float64)

    def run(q, v, n, h):
        lp, g = t.logp_grad(q)
        h0 = hamiltonian(lp, v)

        def step(carry, _):
            q, v, g = carry
            vh = v + 0.5 * h * g
            q = q + h * vh
            lp, g = t.logp_grad(q)
            v = vh + 0.5 * h * g
            return (q, v, g), hamiltonian(lp, v)

        (_, _, _), hs = jax.lax.scan(step, (q, v, g), None, length=n)
        return np.asarray(jnp.max(jnp.abs(hs - h0[None]), axis=0),
                          np.float64)

    h = 0.3 / 1024
    dh64 = run(q64, v64, 1024, h)
    dh32 = run(q64.astype(jnp.float32), v64.astype(jnp.float32), 1024,
               jnp.float32(h))
    assert np.all(np.abs(dh32 - dh64) < 2e-3), np.abs(
        dh32 - dh64).max()
