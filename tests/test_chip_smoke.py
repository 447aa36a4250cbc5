"""``chip_smoke.py``'s phase functions at tiny sizes on the CPU, its
device gate, the NumPy reference it compares with, and the compile
cache helper.  The script's ``main()`` needs a GPU and is not run
here."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import walnuts_tpu as wt
from walnuts_tpu.targets import reference
from walnuts_tpu.utils import compile_cache


@pytest.mark.parametrize("n_cards", [1, 4])
def test_device_gate_refuses_cpu(n_cards):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(n_cards)
    assert exc.value.code not in (0, None)


def test_reference_matches_jax_funnel_in_float64():
    q = np.random.default_rng(1).standard_normal((16, 9))
    lp, g = wt.targets.funnel(9).logp_grad(jnp.asarray(q, jnp.float64))
    r_lp, r_g = reference.funnel_logp_grad(q)
    np.testing.assert_allclose(np.asarray(lp), r_lp, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), r_g, rtol=1e-12,
                               atol=1e-12)
    # a single chain as a 1-D vector, as the NumPy baseline calls it
    lp1, g1 = reference.funnel_logp_grad(q[3])
    np.testing.assert_allclose(lp1, r_lp[3], rtol=1e-15)
    np.testing.assert_allclose(g1, r_g[3], rtol=1e-15)


def test_phase_reference_tiny():
    r = chip_smoke.phase_reference(chains=64, dim=11)
    errs = [v for k, v in r.items() if k.startswith("err_")]
    assert len(errs) == 6
    assert all(0.0 <= e <= r["tol"] for e in errs)
    assert r["ok"] is True


@pytest.mark.parametrize("shift, ok", [(0.0, True), (1.0, False)])
def test_omega_gate(shift, ok):
    """Independent N(0, 3^2) draws pass; draws shifted by 1 (~13
    standard errors here) fail."""
    w = 3.0 * np.random.default_rng(0).standard_normal((200, 64)) + shift
    g = chip_smoke.omega_gate(w)
    assert g["gate_ok"] is ok
    assert 0.5 * w.size < g["ess_mean"] < 2.0 * w.size
    assert math.isclose(g["z_mean"], g["omega_mean"] / g["se_mean"])


def test_phase_fused_tiny():
    r = chip_smoke.phase_fused(chains=64, dim=5, warmup=40, draws=60)
    for k in ("warmup_compile_s", "warmup_s", "compile_s", "sample_s",
              "grad_evals_per_s", "rounds_per_s", "adapted_h",
              "adapted_delta", "warmup_end_omega_mean", "z_mean", "z_sd",
              "se_mean", "se_sd"):
        assert np.isfinite(r[k]), k
    assert r["grad_evals"] > 0 and r["rounds"] > 0
    assert r["draws_per_chain_min"] >= 60
    assert r["adapted_h"] != 0.3      # warmup moved the tuning
    assert r["mem_out_mb"] >= 0.0
    assert r["gate_ok"] and r["shards_ok"] and r["ok"]
    assert r["state"].samples.shape == (60, 64, 2)


def test_phase_scan_tiny():
    r = chip_smoke.phase_scan(chains=64, dim=11, warmup=60, draws=100)
    assert r["finite"] is True
    assert np.isfinite(r["tau"]) and r["tau"] > 0
    assert r["gated"] == (100 >= chip_smoke.GATE_TAUS * r["tau"])
    if not r["gated"]:
        assert "autocorrelation" in r["not_gated_because"]
    assert r["ok"] is True


def test_phase_mesh_on_four_cpu_devices():
    """The mesh phase on 4 of the 8 virtual CPU devices: every
    chain-axis state array holds C/4 chains per device, and the
    per-chain draw counts equal an unsharded run's exactly (the
    counter-hash stream is per chain, and pooled medians do not
    depend on the placement); the draws agree to float32 rounding of
    the differently fused sums."""
    kw = dict(dim=5, warmup=20, draws=20)
    r = chip_smoke.phase_mesh(4, chains_per_card=16, **kw)
    many = r["mesh"]
    assert many["devices"] == 4 and many["chains"] == 64
    assert many["shards_ok"] is True
    assert np.isfinite(r["rate_ratio"]) and r["rate_ratio"] > 0
    st = many["state"]
    assert {s.data.shape[0] for s in st.qc.addressable_shards} == {16}
    assert len({s.device for s in st.it.addressable_shards}) == 4

    flat = chip_smoke.phase_fused(64, **kw)
    np.testing.assert_array_equal(np.asarray(st.it),
                                  np.asarray(flat["state"].it))
    np.testing.assert_allclose(np.asarray(st.samples),
                               np.asarray(flat["state"].samples),
                               rtol=1e-6)
    np.testing.assert_allclose(many["adapted_h"], flat["adapted_h"],
                               rtol=1e-6)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.use_compile_cache()
            assert got == compile_cache.REPO_CACHE_DIR
            assert os.path.dirname(got) == os.path.dirname(
                os.path.abspath(chip_smoke.__file__))
            assert jax.config.jax_compilation_cache_dir == got
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            assert compile_cache.use_compile_cache() == path
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
