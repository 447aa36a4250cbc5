"""Funnel orbit-length study: how the macro step H shapes orbit
length, evaluation cost and funnel coverage.

Regenerates ``WALNUTSpy_examples/funnel/mainFunnelOrbitLen.py:14-51``:
WALNUTS-R2P on the D=11 funnel at ``H in {0.15, 0.3, 0.6}``,
``M=12, delta0=0.1``, no warmup, whole-orbit statistics recorded.  The
reference runs 50k sequential iterations per H with one chain; here
``chains x iters`` supplies the same sample count in parallel.

Per H the output records the distributions the reference's plots are
built from: orbit time length (diag col 2), sampled orbit length
(col 3), doubling depths (cols 1/20), gradient evaluations per
transition (cols 6+7), micro-refinement depth range (cols 21/22), and
the whole-orbit omega coverage (min/max of the generated quantities
over every orbit state).

Each H runs in its own subprocess, one after the other; output JSON
is written atomically after every H.

Usage: python examples/funnel_orbit_len.py [--chains 128] [--iters 400]
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HS = [0.15, 0.3, 0.6]


def atomic_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


def summarize(x):
    x = np.asarray(x, np.float64).ravel()
    x = x[np.isfinite(x)]
    return {
        "mean": float(x.mean()),
        "median": float(np.median(x)),
        "q10": float(np.quantile(x, 0.10)),
        "q90": float(np.quantile(x, 0.90)),
        "max": float(x.max()),
    }


def run_one(h, chains, iters, frag):
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt

    t = wt.targets.funnel(11)
    # reference start: omega ~ N(0, 9), x_i | omega ~ N(0, e^omega)
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    w0 = 3.0 * jax.random.normal(k1, (chains, 1), jnp.float32)
    x0 = jnp.exp(0.5 * w0) * jax.random.normal(k2, (chains, 10),
                                               jnp.float32)
    q0 = jnp.concatenate([w0, x0], axis=-1)

    cfg = wt.WalnutsConfig(m=12, record_orbit_stats=True)
    wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                         adapt_delta=False)
    samples, diags, _, omin, omax = wt.run_walnuts(
        jax.random.PRNGKey(7), q0, target=t, cfg=cfg, warmup=wu,
        num_iter=iters, h0=h, delta0=0.1,
        collect_orbit_stats=True)
    dg = np.asarray(diags, np.float64)
    omin = np.asarray(omin, np.float64)[..., 0]
    omax = np.asarray(omax, np.float64)[..., 0]
    w = np.asarray(samples, np.float64)[1:, :, 0]
    atomic_dump({
        "H": h,
        "orbit_len": summarize(dg[..., 2]),
        "orbit_len_sampled": summarize(dg[..., 3]),
        "doublings_sampled": summarize(dg[..., 1]),
        "doublings_computed": summarize(dg[..., 20]),
        "grad_evals_per_iter": summarize(dg[..., 6] + dg[..., 7]),
        "refine_min": summarize(dg[..., 21]),
        "refine_max": summarize(dg[..., 22]),
        "orbit_omega_min": summarize(omin),
        "orbit_omega_max": summarize(omax),
        "omega_sd": float(w.ravel().std()),
        "total_grad_evals": float(dg[..., 6].sum() + dg[..., 7].sum()),
    }, frag)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--out", default="examples/out_funnel_orbit_len.json")
    ap.add_argument("--one", type=float, default=None)
    ap.add_argument("--frag", default=None)
    args = ap.parse_args()

    if args.one is not None:
        run_one(args.one, args.chains, args.iters, args.frag)
        return

    me = os.path.abspath(__file__)
    rows = []
    for h in HS:
        frag = f"/tmp/funnel_olen_{h}.json"
        r = subprocess.run(
            [sys.executable, me, "--one", str(h), "--frag", frag,
             "--chains", str(args.chains), "--iters", str(args.iters)])
        if r.returncode != 0:
            raise SystemExit(f"H={h} failed")
        with open(frag) as f:
            rows.append(json.load(f))
        atomic_dump({"rows": rows}, args.out)
        print(json.dumps(rows[-1], default=float))


if __name__ == "__main__":
    main()
