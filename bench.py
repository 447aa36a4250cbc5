"""Headline benchmark: WALNUTS on Neal's funnel, D=101, on one GPU.

Prints ONE JSON line on stdout (everything else goes to stderr):
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"extra": {...}}``

* value      = gradient-evaluations/second of the fused engine
               (funnel D=101, adapt_leapfrog_r2p, chain-batched) over
               the timed sampling window, leaving out the first
               invocation's ramp.
* vs_baseline = value / (single-core NumPy grad-evals/s measured at
               runtime with an equivalent sequential WALNUTS loop) —
               the reference publishes no absolute numbers
               (BASELINE.md), so the baseline is measured in-process
               the way the reference runs: one chain, NumPy, float64.

Everything runs in this one process, which fails if JAX finds no GPU:
the pooled in-loop warmup (untimed), the timed sampling run, and then,
after the device phases so that they do not compete with them for host
cores, the NumPy baseline and the native C++ single-core comparator
(native/walnuts_engine.cpp) on the identical funnel-101 config.

Also reported under "extra": min-ESS/s, the posterior sanity check on
the exact omega ~ N(0, 3^2) marginal, the card's name and power limit,
JAX's device kind and the XLA flags in effect.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


CHAINS = 8192
DIM = 101
M = 8
H0 = 0.3
DELTA0 = 0.3
WARMUP = 700       # untimed in-loop megakernel warmup transitions
ITERS = 300        # timed per-chain draw budget (min_per_chain mode)
NATIVE_ITERS = 3000
ROUND_UNROLL = 1   # not yet tuned on the H100
MICRO_UNROLL = 4   # not yet tuned on the H100


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def require_gpu(n_devices=1):
    """Exit nonzero unless JAX's default backend is a GPU with at least
    ``n_devices`` devices."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"JAX found no GPU (platform "
                         f"{devs[0].platform!r}); there is no CPU path")
    if len(devs) < n_devices:
        raise SystemExit(f"{n_devices} GPUs asked for, JAX sees "
                         f"{len(devs)}")


def card_name_and_power():
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ----------------------------------------------------------------------
# Single-core NumPy baseline: sequential WALNUTS-style adaptive loop,
# written here from the paper's protocol (NOT copied from the
# reference): leapfrog halving search to an energy tolerance + the
# same doubling orbit sizes, one chain, float64.  We time its gradient
# throughput, which is what the reference's efficiency metric counts.
# ----------------------------------------------------------------------
def numpy_baseline_grad_evals_per_s(min_seconds=3.0):
    from walnuts_tpu.targets.reference import funnel_logp_grad, leapfrog

    rng = np.random.default_rng(0)
    q = rng.normal(size=DIM) * 0.5
    lp, g = funnel_logp_grad(q)
    n_evals = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min_seconds:
        v = rng.normal(size=DIM)
        h_macro = H0
        # one macro step with halving search to the energy tolerance,
        # then 2^M-state orbit equivalent work: forward + backward scans
        h0 = -lp + 0.5 * v @ v
        for c in range(0, 11):
            n = 2 ** c
            q2, v2, g2, lp2 = leapfrog(funnel_logp_grad, q, v, g,
                                       h_macro / n, n)
            n_evals += n
            if abs((-lp2 + 0.5 * v2 @ v2) - h0) < DELTA0:
                break
        # backward pass (reversibility check, same cost model)
        for cb in range(0, c + 1):
            n = 2 ** cb
            leapfrog(funnel_logp_grad, q2, -v2, g2, h_macro / n, n)
            n_evals += n
            if cb >= c:
                break
        q, lp, g = q2, lp2, g2
        if not np.isfinite(lp):
            q = rng.normal(size=DIM) * 0.5
            lp, g = funnel_logp_grad(q)
    dt = time.perf_counter() - t0
    return n_evals / dt


def warmup_phase():
    """In-loop megakernel warmup with pooled consensus — a long
    (untimed) adaptation, which is what funnel-101's slow omega
    transient needs.  ONE logical run streamed as round-capped
    invocations of one compiled program.  Returns the adapted
    positions and tuning."""
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.sampler.megakernel import run_walnuts_fused

    target = wt.targets.funnel(DIM)
    cfg = wt.WalnutsConfig(m=M)
    q0 = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (CHAINS, DIM),
                                 jnp.float32)
    wu = wt.WarmupConfig(warmup_iter=WARMUP, pooled=True)
    h_t = jnp.full((CHAINS,), H0, jnp.float32)
    d_t = jnp.full((CHAINS,), DELTA0, jnp.float32)
    kw = dict(target=target, cfg=cfg, num_iter=WARMUP, warmup=wu,
              ring_rows=8, rng="hash", rounds=2500)
    key = jax.random.PRNGKey(1)
    stt = None
    done = 0
    while done < WARMUP:
        # tuning carries via mk_state (stt.h_cur/delta_cur)
        *_, stt = run_walnuts_fused(key, q0, h_t, d_t, mk_state=stt, **kw)
        done = int(np.asarray(stt.it).min())
        _log(f"warmup {done}/{WARMUP}")
    return stt.qc, stt.h_cur, stt.delta_cur


def native_phase(h_adapt, delta_adapt):
    """The native C++ single-core engine on the identical funnel-101
    config, at the same warmup-adapted (H, delta) the timed phase
    uses, so min-ESS/s compares engine speed, not tuning."""
    import walnuts_tpu.native as native
    from walnuts_tpu.diagnostics.ess import ess

    rng = np.random.default_rng(3)
    q0 = 0.3 * rng.normal(size=DIM)
    t0 = time.perf_counter()
    draws, n_grad = native.run("funnel", DIM, q0, NATIVE_ITERS,
                               h0=h_adapt, delta=delta_adapt, m=M,
                               seed=7)
    dt = time.perf_counter() - t0
    burn = NATIVE_ITERS // 5
    ess_vals = np.asarray(ess(draws[burn:, None, :]))
    return n_grad / dt, float(ess_vals.min()) / dt


def timed_phase(q1, h_t, d_t):
    """The timed megakernel sampling run, streamed as round-capped
    invocations with full state carry.  Returns the headline
    grad-evals/s and the record's extras."""
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.diagnostics import ess
    from walnuts_tpu.sampler.megakernel import run_walnuts_fused

    # generated quantities (omega, sum x^2) — the reference's two ESS
    # tracking functionals (mainGaussESS.py:50-55) and exactly what
    # the sanity check needs; keeps the carried sample ring at ~20 MB
    target = wt.targets.funnel(DIM, generated=lambda q: jnp.stack(
        [q[..., 0], jnp.sum(q[..., 1:] ** 2, axis=-1)], axis=-1))

    # timed sampling phase: megakernel in min_per_chain mode — every
    # chain delivers its first ITERS draws (fixed transition count
    # per chain, so the stored rectangle is an unbiased equal-weight
    # sample), while chains past quota keep transitioning (no idle
    # tail; all work is real MCMC work and is counted).  Total-budget
    # mode's count-weighted draw pool is length-biased on the funnel
    # (slow = deep-neck chains produce fewer draws).
    kw = dict(target=target, cfg=wt.WalnutsConfig(m=M), num_iter=ITERS,
              stop_mode="min_per_chain", rounds=12000, diag_rows=8,
              rng="hash", micro_unroll=MICRO_UNROLL,
              round_unroll=ROUND_UNROLL)
    key = jax.random.PRNGKey(3)

    # compile both program variants (fresh + resume) before timing
    out_c = run_walnuts_fused(key, q1, h_t, d_t, **kw)
    jax.block_until_ready(run_walnuts_fused(key, q1, h_t, d_t,
                                            mk_state=out_c[-1], **kw))
    _log("timed: compiled")

    t0 = time.perf_counter()
    stt = None
    g_base, t_base = 0, 0.0
    for i in range(400):
        *_, stt = run_walnuts_fused(key, q1, h_t, d_t, mk_state=stt, **kw)
        cnt_min = int(np.asarray(stt.it).min())
        _log(f"timed inv {i}: min cnt {cnt_min}")
        if i == 0 and cnt_min < ITERS:
            # the headline leaves out the first invocation's one-time
            # dispatch/alloc ramp; a run that finishes in one
            # invocation keeps cumulative accounting
            g_base = int(np.asarray(stt.grad_ct, np.int64).sum())
            t_base = time.perf_counter() - t0
        if cnt_min >= ITERS:
            break
    else:
        raise RuntimeError(f"timed: 400 invocations left chains short "
                           f"of {ITERS} draws")
    dt = time.perf_counter() - t0

    cnt = np.asarray(stt.it, np.int64)
    n_grad = int(np.asarray(stt.grad_ct, np.int64).sum())
    grad_per_s = (n_grad - g_base) / (dt - t_base)
    draws = np.asarray(stt.samples, np.float64)
    ess_vals = np.asarray(ess(jnp.asarray(draws)))
    surplus = float(cnt.sum() - CHAINS * ITERS) / (CHAINS * ITERS)
    extra = {
        "chains": CHAINS,
        "iters_timed": ITERS,
        "warmup_iters": WARMUP,
        "seconds": round(dt, 2),
        "adapted_h_median": round(float(np.median(np.asarray(h_t))), 4),
        "adapted_delta_median": round(float(np.median(np.asarray(d_t))),
                                      4),
        "micro_unroll": MICRO_UNROLL,
        "round_unroll": ROUND_UNROLL,
        "grad_evals_per_s_incl_ramp": round(n_grad / dt, 1),
        "min_ess_per_s": round(float(ess_vals.min() / dt), 2),
        "rows_used": ITERS,
        "surplus_draw_fraction": round(surplus, 3),
        # min_per_chain stores only each chain's FIRST ITERS draws;
        # the surplus transitions are draws from the same stationary
        # chains, so the stored rectangle's per-draw ESS rate extends
        # to them (an estimate, not a measurement)
        "min_ess_per_s_all_draws_est": round(
            float(ess_vals.min() / dt) * (1.0 + surplus), 2),
        "omega_sd_abs_error": round(
            abs(float(draws[..., 0].std()) - 3.0), 4),
    }
    if g_base:
        extra["ramp_grad_evals"] = g_base
        extra["ramp_seconds"] = round(t_base, 2)
    return grad_per_s, extra


def main():
    import jax

    from walnuts_tpu.utils.compile_cache import use_compile_cache

    require_gpu()
    card = card_name_and_power()
    use_compile_cache()
    dev = jax.devices()[0]

    q1, h_t, d_t = warmup_phase()
    grad_per_s, extra = timed_phase(q1, h_t, d_t)
    base = numpy_baseline_grad_evals_per_s()
    native_grad, native_ess = native_phase(
        float(np.median(np.asarray(h_t))), float(np.median(np.asarray(d_t))))
    extra.update({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "native_cpp_grad_evals_per_s": round(native_grad, 1),
        "native_cpp_min_ess_per_s": round(native_ess, 3),
        "vs_native_cpp_grad": round(grad_per_s / native_grad, 2),
        "vs_native_cpp_min_ess": round(
            extra["min_ess_per_s"] / max(native_ess, 1e-12), 2),
    })
    print(json.dumps({
        "metric": "grad_evals_per_s_funnel101",
        "value": round(grad_per_s, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(grad_per_s / base, 2),
        "extra": extra,
    }), flush=True)


if __name__ == "__main__":
    main()
