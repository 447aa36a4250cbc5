"""Funnel transient from deep in the neck: start at omega = -30 with
refinement depth allowed up to maxC = 30 and show recovery.

Regenerates ``WALNUTSpy_examples/funnel/mainFunnelTransient.py:14-40``:
WALNUTS-R2P, D=11, ``M=12, H0=0.3, delta0=0.3, minC=0, maxC=30``, no
warmup, whole-orbit statistics.  At omega = -30 the conditional
curvature is ``e^{30} ~ 1e13``, so the step-halving search must reach
micro steps ~``0.3 * 2^{-21}`` — the hardest stress test of the f32
energy-accumulation path (SURVEY §7.3); the reference runs one f64
NumPy chain, here a batch of f32 chains runs on the device.

Recorded (the reference's three panels, ``mainFunnelTransient.py``
plot section): per-iteration omega draws, whole-orbit min/max omega,
micro-step-size range ``0.3 * 2^{-If}`` (diag cols 8/9), and orbit
energy error (col 17); plus per-chain iterations-to-recovery.

The run is chunked (same-shape invocations resume via
``resume_state``) with atomic partial writes, so progress survives an
interrupted run.

Usage: python examples/funnel_transient.py [--chains 16] [--iters 1000]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def atomic_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


def native_main(args):
    """Single-chain run on the native C++ engine — the fast path for
    the reference's 1-chain f64 experiment (the XLA CPU batch run
    below cross-checks its first iterations).  Chunked with atomic
    partial writes; each chunk warm-starts from the last draw (the
    momentum is refreshed every transition, so only the position
    carries) and re-seeds the chunk's RNG from (seed, iters done)."""
    import walnuts_tpu.native as native

    q = np.zeros(11)
    q[0] = -30.0
    draws, diags = [], []
    done = 0
    while done < args.iters:
        n = min(args.chunk, args.iters - done)
        d, ng, dg = native.run(
            "funnel", 11, q, n, h0=0.3, delta=0.3, m=12, min_c=0,
            max_c=args.max_c, seed=args.seed * 100003 + done,
            want_diag=True)
        draws.append(d)
        diags.append(dg)
        q = d[-1]
        done += n
        w = np.concatenate(draws)[:, 0]
        dg_all = np.concatenate(diags)
        rec = {
            "engine": "native_cpp",
            "dtype": "float64",
            "seed": args.seed,
            "iters_done": done,
            "max_c": args.max_c,
            "omega_trace": w[:400].tolist(),
            "orbit_omega_min": dg_all[:400, 2].tolist(),
            "orbit_omega_max": dg_all[:400, 3].tolist(),
            "micro_h_min": (0.3 * 2.0 ** -dg_all[:400, 1]).tolist(),
            "micro_h_max": (0.3 * 2.0 ** -dg_all[:400, 0]).tolist(),
            "orbit_energy_error": dg_all[:400, 4].tolist(),
            "grad_evals_per_iter": dg_all[:400, 5].tolist(),
            "max_if_reached": float(dg_all[:, 1].max()),
        }
        above = w > -5.0
        rec["iters_to_recovery"] = (
            int(np.argmax(above)) if above.any() else -1)
        if rec["iters_to_recovery"] >= 0:
            tail = w[rec["iters_to_recovery"] + 50:]
            if tail.size >= 50:
                rec["omega_sd_post_recovery"] = float(tail.std())
                rec["omega_mean_post_recovery"] = float(tail.mean())
        atomic_dump(rec, args.out)
        print(f"iters={done} omega={w[-1]:.2f} "
              f"rec_iter={rec['iters_to_recovery']}", flush=True)
        # converged enough for the experiment's question? keep going
        # to the full budget anyway (cheap once recovered)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--max-c", type=int, default=30)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--engine", default="xla",
                    choices=["xla", "native"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="examples/out_funnel_transient.json")
    args = ap.parse_args()

    if args.engine == "native":
        native_main(args)
        return

    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import walnuts_tpu as wt

    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    t = wt.targets.funnel(11)
    C = args.chains
    q0 = jnp.zeros((C, 11), dtype).at[:, 0].set(-30.0)

    cfg = wt.WalnutsConfig(
        m=12, record_orbit_stats=True,
        igr=wt.IntegratorConfig(min_c=0, max_c=args.max_c))
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                         adapt_delta=False)

    ws, omins, omaxs, if_mins, if_maxs, eerrs = [], [], [], [], [], []
    state = None
    done = 0
    while done < args.iters:
        n = min(args.chunk, args.iters - done)
        out = wt.run_walnuts(
            jax.random.fold_in(jax.random.PRNGKey(1), done), q0,
            target=t, cfg=cfg, warmup=wu, num_iter=n, h0=0.3,
            delta0=0.3, collect_orbit_stats=True, resume_state=state)
        samples, diags, state, omin, omax = out
        ws.append(np.asarray(samples, np.float64)[1:, :, 0])
        omins.append(np.asarray(omin, np.float64)[..., 0])
        omaxs.append(np.asarray(omax, np.float64)[..., 0])
        dg = np.asarray(diags, np.float64)
        if_mins.append(dg[..., 8])
        if_maxs.append(dg[..., 9])
        eerrs.append(dg[..., 17])
        done += n
        w = np.concatenate(ws)
        rec = {
            "dtype": args.dtype,
            "chains": C,
            "iters_done": done,
            "max_c": args.max_c,
            # the reference's three panels, first 300 iterations
            "omega_trace_median": np.median(w, axis=1)[:300].tolist(),
            "omega_trace_chain0": w[:300, 0].tolist(),
            "orbit_omega_min_chain0":
                np.concatenate(omins)[:300, 0].tolist(),
            "orbit_omega_max_chain0":
                np.concatenate(omaxs)[:300, 0].tolist(),
            "micro_h_min_chain0": (
                0.3 * 2.0 ** -np.concatenate(if_maxs)[:300, 0]
            ).tolist(),
            "micro_h_max_chain0": (
                0.3 * 2.0 ** -np.concatenate(if_mins)[:300, 0]
            ).tolist(),
            "orbit_energy_error_median":
                np.median(np.concatenate(eerrs), axis=1)[:300].tolist(),
        }
        # recovery: first iteration with omega > -5, per chain
        above = w > -5.0
        rec["iters_to_recovery"] = [
            int(np.argmax(above[:, c])) if above[:, c].any() else -1
            for c in range(C)]
        rec["recovered_fraction"] = float(
            np.mean([r >= 0 for r in rec["iters_to_recovery"]]))
        # stationary check on the recovered tail
        if done >= 400:
            tail = w[300:].ravel()
            rec["omega_sd_post_recovery"] = float(tail.std())
            rec["omega_mean_post_recovery"] = float(tail.mean())
        atomic_dump(rec, args.out)
        print(f"iters={done} median_omega={np.median(w[-1]):.2f} "
              f"recovered={rec['recovered_fraction']:.2f}", flush=True)


if __name__ == "__main__":
    main()
