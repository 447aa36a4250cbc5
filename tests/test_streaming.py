"""Streaming (continuous-batching) driver tests: statistical
equivalence with the scan driver and output contract."""

import jax
import jax.numpy as jnp
import numpy as np

import walnuts_tpu as wt
from walnuts_tpu.sampler.streaming import run_walnuts_streaming


def test_streaming_gauss_moments():
    t = wt.targets.std_gauss(10)
    C = 64
    q0 = jax.random.normal(jax.random.PRNGKey(1), (C, 10), jnp.float64)
    h = jnp.full((C,), 0.5, jnp.float64)
    d = jnp.full((C,), 0.1, jnp.float64)
    s, diag, qf = run_walnuts_streaming(
        jax.random.PRNGKey(2), q0, h, d, target=t,
        cfg=wt.WalnutsConfig(m=6), num_iter=400)
    x = np.asarray(s)[100:]
    n_eff = x.shape[0] * x.shape[1] / 8
    assert abs(x.mean()) < 5 / np.sqrt(n_eff)
    assert abs(x.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff)
    # final positions are the last recorded samples
    np.testing.assert_array_equal(np.asarray(qf), np.asarray(s)[-1])


def test_streaming_matches_scan_distributions():
    """Orbit-geometry distributions (doubling depth, stop codes, If
    stats) agree with the synchronised scan driver."""
    t = wt.targets.std_gauss(10)
    C = 128
    q0 = jax.random.normal(jax.random.PRNGKey(1), (C, 10), jnp.float64)
    h = jnp.full((C,), 0.5, jnp.float64)
    dl = jnp.full((C,), 0.1, jnp.float64)
    s1, d1, _ = run_walnuts_streaming(
        jax.random.PRNGKey(2), q0, h, dl, target=t,
        cfg=wt.WalnutsConfig(m=6), num_iter=400)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    s2, d2, _ = wt.run_walnuts(
        jax.random.PRNGKey(2), q0, target=t, cfg=wt.WalnutsConfig(m=6),
        warmup=wu, num_iter=400, h0=0.5, delta0=0.1)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    for col in (1, 20, 19, 8, 9, 21, 22):
        assert abs(d1[..., col].mean() - d2[..., col].mean()) < 0.15, col
    # index statistic histograms agree
    x1 = np.abs(d1[..., 23].ravel())
    x2 = np.abs(d2[..., 23].ravel())
    h1, _ = np.histogram(x1[x1 > 0], bins=10, range=(0, 1))
    h2, _ = np.histogram(x2[x2 > 0], bins=10, range=(0, 1))
    tvd = 0.5 * np.abs(h1 / h1.sum() - h2 / h2.sum()).sum()
    assert tvd < 0.08, tvd


def test_streaming_chunked_resume():
    """Two chunked calls == statistically continuous sampling; shapes
    and finiteness hold."""
    t = wt.targets.funnel(6)
    C = 32
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (C, 6),
                                 jnp.float64)
    h = jnp.full((C,), 0.4, jnp.float64)
    d = jnp.full((C,), 0.3, jnp.float64)
    s1, g1, qf = run_walnuts_streaming(
        jax.random.PRNGKey(1), q0, h, d, target=t,
        cfg=wt.WalnutsConfig(m=5), num_iter=50)
    s2, g2, qf2 = run_walnuts_streaming(
        jax.random.PRNGKey(2), qf, h, d, target=t,
        cfg=wt.WalnutsConfig(m=5), num_iter=50)
    assert s1.shape == (50, C, 6)
    assert g1.shape == (50, C, 24)
    assert np.all(np.isfinite(np.asarray(s2)))
    # chains actually moved across the chunk boundary
    assert not np.allclose(np.asarray(qf), np.asarray(qf2))


def test_streaming_hash_rng_per_chain_reproducible():
    """rng="hash" (default): a chain's draws are a function of its
    global id and its OWN counters only — the first 4 chains of a C=8
    run replay bitwise as a C=4 run (the legacy rng="global" mode
    cannot do this).  Mirrors the fused engine's invariant
    (test_megakernel.py): one RNG semantics across the fast engines."""
    t = wt.targets.std_gauss(8)
    cfg = wt.WalnutsConfig(m=5)
    q0 = jax.random.normal(jax.random.PRNGKey(0), (8, 8), jnp.float64)
    h = jnp.full((8,), 0.5, jnp.float64)
    d = jnp.full((8,), 0.1, jnp.float64)
    s8, d8, _ = run_walnuts_streaming(
        jax.random.PRNGKey(5), q0, h, d, target=t, cfg=cfg,
        num_iter=120)
    s4, d4, _ = run_walnuts_streaming(
        jax.random.PRNGKey(5), q0[:4], h[:4], d[:4], target=t, cfg=cfg,
        num_iter=120)
    assert np.array_equal(np.asarray(s8)[:, :4], np.asarray(s4))
    assert np.array_equal(np.asarray(d8)[:, :4], np.asarray(d4))
    # hash draws are real randomness: stationary moments hold
    x = np.asarray(s8)[30:]
    n_eff = x.shape[0] * x.shape[1] / 8
    assert abs(x.mean()) < 5 / np.sqrt(n_eff)
    assert abs(x.std() - 1.0) < 5 * np.sqrt(0.5 / n_eff)
