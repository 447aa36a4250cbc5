"""Native C++ engine: build, sanity, and cross-engine statistical
agreement with the JAX sampler."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

import walnuts_tpu as wt  # noqa: E402
from walnuts_tpu import native  # noqa: E402


def test_native_builds_and_samples_gaussian():
    draws, ng = native.run("std_gauss", 10, np.zeros(10), 3000,
                           h0=0.5, delta=0.1, m=8, seed=1)
    s = draws[300:]
    assert ng > 0
    n_eff = len(s) / 5
    assert abs(s.mean()) < 5 / np.sqrt(n_eff * 10)
    assert abs(s.std() - 1.0) < 0.05


def test_native_funnel_tail():
    draws, ng = native.run("funnel", 11, np.zeros(11), 6000,
                           h0=0.3, delta=0.3, m=10, seed=2)
    w = draws[1000:, 0]
    assert abs(w.std() - 3.0) < 0.35
    # WALNUTS resolves the tail: left-tail mass near the exact 0.159
    assert (w < -3.0).mean() > 0.10


def test_native_vs_jax_engine_agreement():
    """The native oracle and the JAX engine sample the same posterior:
    compare funnel omega moments and quantiles."""
    # pool three native chains: single-chain funnel omega has MC error
    # ~0.4 in the mean even at 18k draws (measured), so pool and use
    # 5-sigma-ish bounds
    w_n = np.concatenate([
        native.run("funnel", 11, np.zeros(11), 20000,
                   h0=0.3, delta=0.3, m=9, seed=s)[0][2000:, 0]
        for s in (3, 4, 5)])

    t = wt.targets.funnel(11)
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (64, 11),
                                 jnp.float64)
    cfg = wt.WalnutsConfig(m=9)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    samples, _, _ = wt.run_walnuts(
        jax.random.PRNGKey(1), q0, target=t, cfg=cfg, warmup=wu,
        num_iter=500, h0=0.3, delta0=0.3)
    w_j = np.asarray(samples)[100:, :, 0].ravel()

    assert abs(w_n.mean() - w_j.mean()) < 0.45
    assert abs(w_n.std() - w_j.std()) < 0.3
    assert abs((w_n < -3).mean() - (w_j < -3).mean()) < 0.05
    for p in (0.25, 0.5, 0.75):
        assert abs(np.quantile(w_n, p) - np.quantile(w_j, p)) < 0.5, p


def test_native_leapfrog_bench_runs():
    n = native.leapfrog_bench("std_gauss", 50, 100_000, h=0.01)
    assert n == 100_000
