"""Stock-Watson stochastic-volatility model: WALNUTS vs NUTS posterior
quantile bands on real OECD inflation data.

Regenerates ``WALNUTSpy_examples/StockWatson/mainSW.py:41-84`` /
``plotsSW.py:60-141`` with the BridgeStan FFI replaced by the native
JAX model (``walnuts_tpu.targets.stock_watson``): runs WALNUTS-D
(``M=14, H0=0.1, delta0=0.3, minC=3``), WALNUTS-R2P, and NUTS
(``H0=0.002``), then compares posterior quantile bands of the
constrained quantities (sigma, z, x, tau) across samplers.

Engine: the fused megakernel (all three protocols live in its state
machine since round 3) streamed as ~5 s round-capped invocations.

**Model choice (round-4 discovery).** The reference model as shipped
has an IMPROPER posterior: ``sw_innov.stan:40-42`` comments out the
initial-state priors, leaving the density exactly flat as
``z1 -> -inf`` (see ``walnuts_tpu/targets/stock_watson.py`` and
``tests/test_targets.py::test_stock_watson_reference_model_has_flat_z1_tail``).
Multi-chain z traces drift apart forever (measured cross-chain z sd
~113 after 4000 transitions), so no sampler can pass a split-Rhat
gate on it — the reference's single 11k-draw chain simply wandered
slowly from its unshipped ``initq.npy`` start.  The gated artifact
therefore runs ``stock_watson(proper=True)`` (the commented-out
N(0,1) priors restored); ``--model reference`` runs the verbatim
improper model for an UNGATED parity arm on the identified
quantities (sigma, x, tau).

Protocol: the reference runs ``warmupIter=0`` at FIXED tuning
(``mainSW.py:41-49``) from a precomputed ``initq.npy`` start that is
NOT shipped; ``--init mode`` (the default) regenerates that missing
artifact with a deterministic Adam mode search + 0.5-sd jitter.  Stan's
default ``U(-2, 2)`` unconstrained init (``--init stan``) is measurably
unusable on this model: iid +-2 draws on the ~750 innovation
coordinates compound through the state cumsums to ``|z| ~ 30-50``, so
``exp(z/2)`` reaches 1e6-1e11, tau blows up to ~1e11, and every chain
freezes in the flat far tail (probed: split-Rhat 2.8e9, tau window
means pinned at -9.3e10 for 2000 transitions) — which is exactly why
the reference precomputed an init.  After init, a burn-in segment with
a tiny ring, then the sampling phase streamed as <= 500-draw SEGMENTS,
each holding its chains' first ``n`` post-boundary draws exactly
(``min_per_chain`` stores only the first-K rows, so a segment ring
never wraps); segments concatenate into each chain's contiguous first
``--iters`` draws, and disk checkpoints at segment boundaries make
a rerun of an interrupted arm resume instead of redo (see run_one).  Many
chains replace the reference's 11k single-chain run, and
convergence is asserted with split-Rhat < 1.05 (VERDICT r2 item 2)
rather than eyeballed.  ``--warmup N`` optionally enables the in-loop
pooled H/delta adaptation instead of the reference's fixed tuning.

Usage: python examples/stock_watson.py [--chains 256] [--iters 400]
"""

import argparse
import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


# (tag, integrator, H0, igr kwargs, adaptive, m)
# m per arm: the U-turn criterion ends SW orbits at span ~5-10 time
# units, i.e. depth ~6-7 at H0=0.1 — m=10 caps only straggler orbits
# for the WALNUTS arms; NUTS at H0=0.002 needs 2^m * 0.002 >= that
# span, so it keeps m=12 (the reference runs everything at M=14,
# which its own U-turn also never fills at stationarity)
CONFIGS = [
    ("walnuts_d", "adapt_leapfrog_d", 0.1, dict(min_c=3), True, 10),
    ("walnuts_r2p", "adapt_leapfrog_r2p", 0.1, dict(min_c=3), True, 10),
    ("nuts", "fixed_leapfrog", 0.002, dict(), False, 12),
]

# bumped whenever the harness semantics change; fragments carry it so
# a rerun can never silently reuse results from an older harness
HARNESS_VERSION = 6


def find_mode(t, steps=4000, lr=0.02, polish_steps=0,
              polish_lr=0.002):
    """Deterministic posterior-mode search (Adam ascent from the NCP
    prior mean).  The reference experiment runs ``warmupIter=0`` from
    a precomputed ``initq.npy`` that is NOT shipped
    (``mainSW.py:32,41-49``) — this regenerates the missing artifact:
    chains then start at mode + jitter and sample at the reference's
    FIXED tuning, exactly like ``mainSW.py``."""
    import jax
    import jax.numpy as jnp
    import optax

    def make_run(opt, n):
        @jax.jit
        def run(q0):
            def step(carry, _):
                q, st = carry
                lp, g = t.logp_grad(q)
                upd, st2 = opt.update(jax.tree_util.tree_map(
                    lambda x: -x, g), st)
                return (optax.apply_updates(q, upd), st2), lp

            (q, _), lps = jax.lax.scan(
                step, (q0, opt.init(q0)), None, length=n)
            return q, lps[-1]

        return run

    q, lp = make_run(optax.adam(lr), steps)(
        jnp.zeros((t.dim,), jnp.float32))
    if polish_steps:
        # NOTE: polishing climbs into a steep high-density ridge
        # (grad norm explodes ~200x while lp rises) — the SW
        # log-volatility hierarchy concentrates density away from the
        # typical set, so a *gentle* stationary-ish point is the
        # better chain init; keep polish off by default
        q, lp = make_run(optax.adam(polish_lr), polish_steps)(q)
    return q, float(lp)


def _parse_overrides(pairs):
    """['tag=N', ...] -> {tag: N} for per-arm iters/burnin overrides."""
    out = {}
    for p in pairs or []:
        tag, _, val = p.partition("=")
        out[tag] = int(val)
    return out


def _effective(args, tag):
    """(iters, burnin) for this arm after per-arm overrides.

    Round-4 finding: the R2P arm mixes slower than D on this model
    (split-Rhat 1.116 vs 1.0195 at 2000 draws / 400 burn-in), so it
    needs a longer run than the other arms to clear the 1.05 gate —
    overrides let one arm be extended without invalidating the other
    arms' committed fragments (the stamp stores effective values)."""
    it = _parse_overrides(args.iters_override).get(tag, args.iters)
    bu = _parse_overrides(args.burnin_override).get(tag, args.burnin)
    return it, bu


def _stamp(args, tag):
    """Config fingerprint stored in (and required of) every fragment."""
    row, = [c for c in CONFIGS if c[0] == tag]
    it, bu = _effective(args, tag)
    return {
        "harness_version": HARNESS_VERSION,
        "tag": tag,
        "integrator": row[1],
        "h0": row[2],
        "igr": row[3],
        "chains": args.chains,
        "iters": it,
        "warmup": args.warmup,
        "burnin": bu,
        "m": row[5] if args.m == 0 else args.m,
        "model": args.model,
        "init": args.init,
    }


def _stream(key, q0, h_t, d_t, *, target, cfg, num_iter, warmup=None,
            ring_rows=None, rounds=2500, max_inv=None, tag="",
            log_every=20):
    """One logical megakernel run as round-capped invocations.

    ``max_inv`` scales with the draw quota: SW transitions average
    ~2000 rounds each (deep m=10 orbits of min_c=3 trials), so a
    2500-round invocation advances the slowest chain by ~1 draw — a
    fixed cap would silently truncate long runs (caught live in r5:
    a 6000-draw stream would have stopped at ~1800 draws and left
    the rest of the ring zero-filled)."""
    import jax
    import numpy as np

    from walnuts_tpu.sampler.megakernel import run_walnuts_fused

    kw = dict(target=target, cfg=cfg, num_iter=num_iter,
              stop_mode="min_per_chain", rounds=rounds, diag_rows=8,
              rng="hash")
    if warmup is not None:
        kw["warmup"] = warmup
    if ring_rows is not None:
        kw["ring_rows"] = ring_rows
    if max_inv is None:
        max_inv = 2000 + 3 * num_iter
    stt = None
    for i in range(max_inv):
        out = run_walnuts_fused(key, q0, h_t, d_t, mk_state=stt, **kw)
        stt = out[-1]
        done = int(np.asarray(stt.it).min())
        if i % log_every == 0:
            print(f"{tag}: inv {i} min_draws {done}/{num_iter}",
                  flush=True)
        if done >= num_iter:
            break
    return stt


def run_one(args, only):
    """Run ONE sampler config in its own process (the arms run one
    after the other, so one process holds the device at a time) and
    dump its summary JSON fragment."""
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.diagnostics import split_rhat

    t = wt.targets.stock_watson(proper=(args.model == "proper"))
    T = 252
    C = args.chains
    (tag, integ, h0, igr_kw, adapt, m_arm), = [
        c for c in CONFIGS if c[0] == only]
    arm_iters, arm_burnin = _effective(args, tag)
    m = m_arm if args.m == 0 else args.m
    cfg = wt.WalnutsConfig(m=m, integrator=integ,
                           igr=wt.IntegratorConfig(**igr_kw))
    if args.init == "mode":
        # default protocol: Adam mode search + 0.5-sd jitter — the
        # regenerated equivalent of the reference's unshipped
        # initq.npy (mainSW.py:32).  On the improper reference model
        # the "mode" is ill-defined in the flat z1 direction but the
        # gentle (unpolished) Adam point is still a sane start.
        mode, mode_lp = find_mode(t)
        print(f"{tag}: mode logp {mode_lp:.1f}", flush=True)
        q0 = mode[None, :] + 0.5 * jax.random.normal(
            jax.random.PRNGKey(0), (C, t.dim), jnp.float32)
    else:
        # Stan's default unconstrained init, kept for the record: iid
        # U(-2, 2) on the raw innovations compounds through the state
        # cumsums to |z| ~ 30-50, exp(z/2) ~ 1e6-1e11 — chains start
        # frozen in the flat far tail and never recover (see module
        # docstring).  Do not use for the gated artifact.
        q0 = jax.random.uniform(jax.random.PRNGKey(0), (C, t.dim),
                                jnp.float32, -2.0, 2.0)
    # crc32, not hash(): Python string hashes are salted per process
    # (PYTHONHASHSEED), which would make every run a different seed
    key = jax.random.PRNGKey(zlib.crc32(tag.encode()) & 0x7FFFFFFF)
    h_t = jnp.full((C,), h0, jnp.float32)
    d_t = jnp.full((C,), 0.3, jnp.float32)
    t0 = time.perf_counter()
    n_grad = 0
    secs_prev = 0.0

    # Disk checkpoints between phases/segments: a rerun of an
    # interrupted arm resumes after the burn-in and every completed
    # sample segment instead of redoing them.  The phases are
    # deterministic given (stamp, phase index), so resume is exact.  Only the fixed-tuning protocol (warmup == 0) is
    # checkpointed.
    ck_dir = "/var/tmp/sw_ckpt"
    os.makedirs(ck_dir, exist_ok=True)
    ck = os.path.join(ck_dir, tag)
    meta_path = ck + ".meta.json"
    meta = {"stamp": _stamp(args, tag), "burnin_done": False,
            "segs": 0, "n_grad": 0, "secs": 0.0}
    use_ck = args.warmup == 0
    if use_ck and os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                cand = json.load(f)
            if cand.get("stamp") == meta["stamp"]:
                meta = cand
                secs_prev = float(meta.get("secs", 0.0))
                print(f"{tag}: resuming from checkpoint "
                      f"(burnin_done={meta['burnin_done']}, "
                      f"segs={meta['segs']})", flush=True)
        except Exception:
            pass

    def save_meta():
        if not use_ck:
            return
        meta["secs"] = secs_prev + (time.perf_counter() - t0)
        tmpm = meta_path + ".tmp"
        with open(tmpm, "w") as f:
            json.dump(meta, f)
        os.replace(tmpm, meta_path)

    if adapt and args.warmup > 0:
        wu = wt.WarmupConfig(warmup_iter=args.warmup, pooled=True)
        stt = _stream(key, q0, h_t, d_t, target=t, cfg=cfg,
                      num_iter=args.warmup, warmup=wu, ring_rows=8,
                      tag=tag + ":warmup")
        q0 = stt.qc
        h_t, d_t = stt.h_cur, stt.delta_cur
        n_grad += int(np.asarray(stt.grad_ct, np.int64).sum())
    if meta["burnin_done"]:
        q0 = jnp.asarray(np.load(ck + ".qburn.npy"))
        n_grad = meta["n_grad"]
    elif arm_burnin > 0:
        stt = _stream(jax.random.fold_in(key, 1), q0, h_t, d_t,
                      target=t, cfg=cfg, num_iter=arm_burnin,
                      ring_rows=8, tag=tag + ":burnin")
        q0 = stt.qc
        n_grad += int(np.asarray(stt.grad_ct, np.int64).sum())
        if use_ck:
            np.save(ck + ".qburn.npy", np.asarray(q0, np.float32))
            meta.update(burnin_done=True, n_grad=n_grad)
            save_meta()

    # The sample phase streams in SEGMENTS of <= 500 draws with a
    # ring sized to the segment.  A single num_iter-sized ring is
    # quadratically wasteful: the megakernel flush rewrites the whole
    # [R, C, dg] ring every 16 rounds (dense one-hot masked write),
    # so at R = 6000 the flush rewrites 2.3 GB every 16 rounds and
    # dominates the run.  Each
    # segment holds its chains' FIRST `n` draws exactly as before;
    # segments concatenate into the same contiguous per-chain draw
    # sequence (q0 carries across segment boundaries).
    key_s = jax.random.fold_in(key, 2)
    seg_size = int(os.environ.get("SW_SEGMENT", "500"))
    n_seg = -(-arm_iters // seg_size)
    i_seg = meta["segs"] if use_ck else 0
    if i_seg > 0:
        q_cur = jnp.asarray(np.load(ck + f".q{i_seg}.npy"))
        n_grad = meta["n_grad"]
    else:
        q_cur = q0
    remaining = arm_iters - i_seg * seg_size
    while remaining > 0:
        n = min(seg_size, remaining)
        stt = _stream(jax.random.fold_in(key_s, i_seg), q_cur, h_t,
                      d_t, target=t, cfg=cfg, num_iter=n,
                      tag=f"{tag}:sample{i_seg}")
        got = int(np.asarray(stt.it).min())
        if got < n:
            raise SystemExit(
                f"{tag}: segment {i_seg} truncated at {got}/{n} "
                "draws — refusing to write a zero-padded fragment")
        q_cur = stt.qc
        n_grad += int(np.asarray(stt.grad_ct, np.int64).sum())
        remaining -= n
        i_seg += 1
        if use_ck:
            np.save(ck + f".gen{i_seg - 1}.npy",
                    np.asarray(stt.samples, np.float32)[:n])
            np.save(ck + f".q{i_seg}.npy",
                    np.asarray(q_cur, np.float32))
            meta.update(segs=i_seg, n_grad=n_grad)
            save_meta()
        else:
            np.save(ck + f".gen{i_seg - 1}.npy",
                    np.asarray(stt.samples, np.float32)[:n])
    dt = secs_prev + time.perf_counter() - t0

    gen = np.concatenate(
        [np.load(ck + f".gen{i}.npy").astype(np.float64)
         for i in range(n_seg)], axis=0)
    for i in range(n_seg):
        os.remove(ck + f".gen{i}.npy")
    for p in (meta_path, ck + ".qburn.npy") + tuple(
            ck + f".q{i}.npy" for i in range(1, n_seg + 1)):
        if os.path.exists(p):
            os.remove(p)
    # constrained layout: [sigma, z (T-1), x (T), tau (T)]
    bands = {}
    for name, sl in [("sigma", slice(0, 1)),
                     ("z", slice(1, T)),
                     ("x", slice(T, 2 * T)),
                     ("tau", slice(2 * T, 3 * T))]:
        block = gen[:, :, sl].reshape(-1, sl.stop - sl.start)
        bands[name] = {
            "q10": np.quantile(block, 0.10, axis=0).mean(),
            "q50": np.quantile(block, 0.50, axis=0).mean(),
            "q90": np.quantile(block, 0.90, axis=0).mean(),
        }
    import jax.numpy as jnp2

    from walnuts_tpu.diagnostics import ess as ess_fn

    # split-Rhat over EVERY constrained coordinate (r4 gated on the
    # ::50 coordinate subsample only — note: the subsample is over the
    # COORDINATE axis, all retained draws always enter the statistic).
    # Batched over coordinate blocks so the [iters, C, 756] f64 cube
    # never sits on-device at once.
    dg = gen.shape[2]
    rh_full = np.empty((dg,), np.float64)
    for lo in range(0, dg, 64):
        blk = jnp2.asarray(gen[:, :, lo:lo + 64], jnp2.float32)
        rh_full[lo:lo + 64] = np.asarray(split_rhat(blk))
    rh = rh_full[::50]
    # IACT (= retained draws per chain / per-chain ESS contribution)
    # of the slowest-mixing coordinates, for the mixing-rate record
    worst = np.argsort(rh_full)[-4:][::-1]
    iact = {}
    for ci in worst:
        e = float(np.asarray(ess_fn(
            jnp2.asarray(gen[:, :, int(ci)], jnp2.float32))))
        iact[int(ci)] = round(gen.shape[0] * C / max(e, 1.0), 1)
    res = {
        "bands": bands,
        "grad_evals": float(n_grad),
        "seconds": round(dt, 1),
        "chains": C,
        "retained_draws": int(arm_iters) * C,
        "warmup": args.warmup if adapt else 0,
        "burnin": arm_burnin,
        "max_split_rhat_subsampled": float(np.max(rh)),
        "max_split_rhat_all_coords": float(np.max(rh_full)),
        "argmax_rhat_coord": int(np.argmax(rh_full)),
        "iact_slowest_coords": iact,
        "H_final_median": float(np.median(np.asarray(h_t))),
        "delta_final_median": float(np.median(np.asarray(d_t))),
        "stamp": _stamp(args, tag),
    }
    print(json.dumps({tag: res["bands"]["tau"],
                      "grad_evals": n_grad,
                      "max_split_rhat": res["max_split_rhat_subsampled"]},
                     default=float), flush=True)
    tmp = args.out + "." + tag + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, default=float)
    os.replace(tmp, args.out + "." + tag)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--iters", type=int, default=400)
    # default 0 = the reference experiment's fixed-tuning protocol
    # (mainSW.py: warmupIter=0, H0/delta0 as given); pass >0 to adapt
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--burnin", type=int, default=500)
    ap.add_argument("--m", type=int, default=0,
                    help="0 = per-arm default from CONFIGS")
    ap.add_argument("--model", default="proper",
                    choices=["proper", "reference"],
                    help="'proper' restores the sw_innov.stan:40-42 "
                         "commented-out priors (gated artifact); "
                         "'reference' is the verbatim improper model "
                         "(ungated parity arm)")
    ap.add_argument("--init", default="mode", choices=["stan", "mode"])
    ap.add_argument("--iters-override", action="append", default=None,
                    metavar="TAG=N",
                    help="per-arm retained-draw override, e.g. "
                         "walnuts_r2p=6000 (R2P mixes slower; see "
                         "_effective)")
    ap.add_argument("--burnin-override", action="append", default=None,
                    metavar="TAG=N")
    ap.add_argument("--out", default="examples/out_stock_watson.json")
    ap.add_argument("--only", default=None)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore committed per-sampler fragments")
    args = ap.parse_args()

    if args.only:
        run_one(args, args.only)
        return

    import subprocess

    me = os.path.abspath(__file__)
    runs = {}
    for tag, *_ in CONFIGS:
        frag = args.out + "." + tag
        if os.path.exists(frag) and not args.fresh:
            with open(frag) as f:
                cand = json.load(f)
            # fragments are only reusable if they were produced by
            # THIS harness version and config (VERDICT r3 weak #3:
            # stale round-2 fragments silently "passed" a rerun)
            if cand.get("stamp") == _stamp(args, tag):
                runs[tag] = cand
                print(f"{tag}: reusing committed fragment")
                continue
            print(f"{tag}: fragment stamp mismatch "
                  f"(got {cand.get('stamp')}) — regenerating")
        cmd = [sys.executable, me, "--chains", str(args.chains),
               "--iters", str(args.iters), "--warmup",
               str(args.warmup), "--burnin", str(args.burnin),
               "--m", str(args.m), "--model", args.model,
               "--init", args.init, "--out", args.out,
               "--only", tag]
        for ov in args.iters_override or []:
            cmd += ["--iters-override", ov]
        for ov in args.burnin_override or []:
            cmd += ["--burnin-override", ov]
        if subprocess.run(cmd).returncode != 0:
            raise SystemExit(f"stock-watson {tag} failed")
        with open(frag) as f:
            runs[tag] = json.load(f)

    # acceptance: quantile bands agree across samplers (plotsSW.py)
    # AND every sampler is converged (split-Rhat < 1.05)
    def band_gap(a, b):
        return max(abs(runs[a]["bands"][k][q] - runs[b]["bands"][k][q])
                   for k in ("sigma", "z", "x", "tau")
                   for q in ("q10", "q50", "q90"))

    # gate on the strongest convergence stat each fragment carries:
    # all-coordinate split-Rhat where present (harness >= v6 with the
    # full scan), else the ::50 coordinate subsample (older fragments;
    # all retained draws enter the statistic either way)
    def gate_stat(tag):
        r = runs[tag]
        return r.get("max_split_rhat_all_coords",
                     r["max_split_rhat_subsampled"])

    res = {
        "model": args.model,
        "init": args.init,
        "runs": runs,
        "band_gap_walnutsD_vs_r2p": band_gap("walnuts_d", "walnuts_r2p"),
        "band_gap_walnutsD_vs_nuts": band_gap("walnuts_d", "nuts"),
        "gate_stat_per_arm": {tag: gate_stat(tag) for tag in runs},
        "max_split_rhat_all": max(gate_stat(tag) for tag in runs),
    }
    print(json.dumps({k: v for k, v in res.items() if k != "runs"},
                     default=float), flush=True)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, default=float)
    os.replace(tmp, args.out)
    if args.model == "reference":
        print("NOTE: reference model is improper in z1 "
              "(sw_innov.stan:40-42) — split-Rhat gate not applied")
    elif res["max_split_rhat_all"] >= 1.05:
        raise SystemExit("FAIL: a sampler has split-Rhat >= 1.05")


if __name__ == "__main__":
    main()
