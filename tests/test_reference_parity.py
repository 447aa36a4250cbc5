"""Statistical parity against the reference WALNUTSpy implementation.

Runs the actual reference sampler (the read-only mount named by
``REF``) and our JAX engine on an identical fixed-tuning
configuration, then compares sampler-behaviour distributions: posterior
moments, orbit-doubling counts, refinement depths, and the col-23
index-statistic histogram.  This is the "match WALNUTSpy within
Monte-Carlo error" acceptance gate of BASELINE.md.

Skipped when the reference mount is absent.
"""

import os
import sys

import numpy as np
import pytest

REF = "/root/reference/WALNUTSpy"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference mount not available")

# shared configuration (fixed tuning, no adaptation)
DIM = 10
H0 = 0.5
DELTA0 = 0.1
M = 6


@pytest.fixture(scope="module")
def reference_run():
    sys.path.insert(0, REF)
    import matplotlib
    matplotlib.use("Agg")
    np.random.seed(7)
    import WALNUTS as wn
    import adaptiveIntegrators as ai
    import targetDistr as td

    samples, diag = wn.WALNUTS(
        td.stdGauss, np.random.normal(size=DIM), lambda q: q,
        integrator=ai.adaptLeapFrogR2P, H0=H0, delta0=DELTA0,
        numIter=3000, warmupIter=0, adaptH=False, adaptDelta=False, M=M)
    return samples, diag


@pytest.fixture(scope="module")
def our_run():
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt

    t = wt.targets.std_gauss(DIM)
    q0 = jax.random.normal(jax.random.PRNGKey(0), (32, DIM), jnp.float64)
    cfg = wt.WalnutsConfig(m=M)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
    samples, diags, state = wt.run_walnuts(
        jax.random.PRNGKey(1), q0, target=t, cfg=cfg, warmup=wu,
        num_iter=300, h0=H0, delta0=DELTA0)
    return np.asarray(samples), np.asarray(diags)


def test_moments_match(reference_run, our_run):
    ref_s = reference_run[0][:, 500:]          # [D, iters], drop transient
    our_s = our_run[0][50:]                     # [iters, C, D]
    assert abs(ref_s.mean() - our_s.mean()) < 0.1
    assert abs(ref_s.std() - our_s.std()) < 0.06


def test_doubling_depth_distribution(reference_run, our_run):
    """Mean sampled/computed doublings agree (same H/delta/M => same
    orbit geometry in distribution)."""
    ref_d = reference_run[1]
    our_d = our_run[1].reshape(-1, 24)
    for col in (1, 20):  # NdoublSampled, NdoublComputed
        r = ref_d[:, col].mean()
        o = our_d[:, col].mean()
        assert abs(r - o) < 0.3, (col, r, o)


def test_refinement_depth_distribution(reference_run, our_run):
    """Within-orbit step-halving depths (min/max If over orbit, col 8/9)
    agree in mean."""
    ref_d = reference_run[1]
    our_d = our_run[1].reshape(-1, 24)
    for col in (8, 9, 21, 22):
        r = ref_d[:, col].mean()
        o = our_d[:, col].mean()
        assert abs(r - o) < 0.25, (col, r, o)


def test_index_stat_histogram_matches(reference_run, our_run):
    """Total-variation distance between the reference's and our |col 23|
    index-statistic histograms is small."""
    ref_x = np.abs(reference_run[1][:, 23])
    our_x = np.abs(our_run[1][..., 23].ravel())
    ref_x, our_x = ref_x[ref_x > 0], our_x[our_x > 0]
    hr, _ = np.histogram(ref_x, bins=10, range=(0, 1))
    ho, _ = np.histogram(our_x, bins=10, range=(0, 1))
    tvd = 0.5 * np.abs(hr / hr.sum() - ho / ho.sum()).sum()
    assert tvd < 0.08, (tvd, hr / hr.sum(), ho / ho.sum())


def test_energy_error_distribution(reference_run, our_run):
    """Orbit energy-error (col 17) distributions agree in median."""
    ref_e = reference_run[1][:, 17]
    our_e = our_run[1][..., 17].ravel()
    assert abs(np.median(ref_e) - np.median(our_e)) < 0.03
