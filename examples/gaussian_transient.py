"""Transient-phase experiment: convergence of ``sum(q^2)`` from
``q = 0`` into the chi-square band.

Regenerates ``WALNUTSpy_examples/gaussian/mainGaussTransient.py:14-87``
/ ``plotsGaussTransient.py:33-36`` at the reference's scale: for each
dimension d = 2^11..2^15, chains start at the origin and we track the
fraction of chains whose ``sum(q^2)`` sits inside the central
[0.5%, 99.5%] chi-square band per iteration, for the reference's three
arms — WALNUTS-D and WALNUTS-R2P at ``H = d^{-1/4}`` and NUTS (fixed
leapfrog) at ``H = d^{-1/2}`` — with ``delta = 0.3``, M = 10,
31 iterations, 50 repetitions (= chains here; the reference runs 50
sequential single-chain repetitions).

Also recorded per arm, matching the reference's saved arrays: the
micro-step-size range ``H * 2^{-If}`` (diag cols 8/9) and cumulative
gradient-eval counts (cols 6/7).

Acceptance (VERDICT r2 item 4): every arm must put >= 95% of chains
inside the band within 31 iterations at every dimension; the script
exits nonzero otherwise (after writing the JSON).

Usage: python examples/gaussian_transient.py [--dims 2048 ... 32768]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np
from scipy import stats


ARMS = [
    ("walnuts_d", "adapt_leapfrog_d", -0.25),
    ("walnuts_r2p", "adapt_leapfrog_r2p", -0.25),
    ("nuts", "fixed_leapfrog", -0.5),
]


def atomic_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="+",
                    default=[2 ** k for k in range(11, 16)])
    ap.add_argument("--chains", type=int, default=50)
    ap.add_argument("--iters", type=int, default=31)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default="examples/out_gaussian_transient.json")
    args = ap.parse_args()

    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import walnuts_tpu as wt

    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    out = []
    ok_all = True
    for d in args.dims:
        # store only sum(q^2) (the reference's `gen`), never the full
        # [iters, C, d] position history — at d = 2^15 that history
        # would be a multi-hundred-MB carried ring and the experiment
        # never reads it
        t = wt.targets.std_gauss(
            d, generated=lambda q: jnp.sum(q * q, axis=-1,
                                           keepdims=True))
        lo = stats.chi2.ppf(0.005, d)
        hi = stats.chi2.ppf(0.995, d)
        q0 = jnp.zeros((args.chains, d), dtype)
        row = {"d": d, "band": [lo, hi], "chains": args.chains,
               "dtype": args.dtype}
        for tag, integ, hexp in ARMS:
            h = float(d) ** hexp
            cfg = wt.WalnutsConfig(m=10, integrator=integ)
            wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                                 adapt_delta=False)
            samples, diags, _ = wt.run_walnuts(
                jax.random.PRNGKey(d), q0, target=t, cfg=cfg,
                warmup=wu, num_iter=args.iters, h0=h, delta0=0.3)
            sq = np.asarray(samples, np.float64)[..., 0]  # [it+1, C]
            dg = np.asarray(diags, np.float64)
            inside = (sq >= lo) & (sq <= hi)
            frac = inside.mean(axis=1)
            first_in = int(np.argmax(frac >= 0.95)) if np.any(
                frac >= 0.95) else -1
            row[tag] = {
                "H": h,
                "frac_inside_by_iter": frac.tolist(),
                "iters_to_95pct_inside": first_in,
                # reference's hmins/hmaxs panels: H * 2^-If range
                "micro_h_min_by_iter": (
                    h * 2.0 ** -dg[..., 9].max(axis=1)).tolist(),
                "micro_h_max_by_iter": (
                    h * 2.0 ** -dg[..., 8].min(axis=1)).tolist(),
                "cum_grad_evals_mean": np.cumsum(
                    (dg[..., 6] + dg[..., 7]).mean(axis=1)).tolist(),
            }
            passed = 0 <= first_in <= args.iters
            ok_all &= passed
            print(json.dumps({"d": d, "arm": tag, "H": h,
                              "iters_to_95pct_inside": first_in,
                              "pass_within_31": passed}), flush=True)
        out.append(row)
        atomic_dump(out, args.out)

    if not ok_all:
        raise SystemExit("FAIL: an arm did not reach the chi2 band "
                         "within the iteration budget")


if __name__ == "__main__":
    main()
