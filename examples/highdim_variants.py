"""BASELINE config 5: implicit-midpoint and isokinetic/microcanonical
WALNUTS variants at D = 10^4, chain-sharded over a device mesh.

The reference only ever runs these variants at toy dimension on one
CPU core (implicit midpoint: ``WALNUTSpy/adaptiveIntegrators.py:478-641``;
isokinetic/microcanonical: ``isokinetic/microCanonical.py:266-316`` with
the smile/corrGauss targets at D = 2).  This experiment takes the same
samplers to D = 10,000 on standard and ill-conditioned (diagonal
variances log-spaced over [1, 1e4]) Gaussians, with the chain batch
sharded across every available device (``parallel.make_mesh`` +
``shard_chains`` — the 8-virtual-device CPU mesh in the tests, the
cards on a GPU host), and gates on posterior moments within Monte-Carlo error:

* per-coordinate z-scores of the mean of ``q_0`` and ``q_{D-1}``
  (normalised by the target sd) against ESS-based standard errors;
* the normalised squared radius ``sum(q^2 / var)`` against its exact
  chi^2_D law (mean D, sd sqrt(2D)), again with an ESS-based se.

Arms:

* ``im_std`` / ``im_illcond`` — WALNUTS with the adaptive implicit
  midpoint integrator (``adapt_implicit_midpoint_d``, Newton solve per
  micro step) on the scan engine;
* ``iso_std`` / ``iso_illcond`` — the isokinetic kernel
  (``adapt_mc_step_e`` analog: cosh/sinh B-A-B splitting with
  per-macro-step halving to an error tolerance) under the generic
  NUTS orbit driver.

Usage: python examples/highdim_variants.py [--dim 10000] [--chains 32]
       [--devices 8]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ARMS = ["im_std", "im_illcond", "iso_std", "iso_illcond"]


def atomic_dump(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


def make_target(arm, dim):
    """Target plus the generated quantities [q_0/sd_0, q_last/sd_last,
    sum(q^2/var)] — everything the moment gates need, at storage cost
    3 instead of D."""
    import jax.numpy as jnp

    import walnuts_tpu as wt

    if arm.endswith("_std"):
        var = None

        def logp_grad(q):
            return -0.5 * jnp.sum(q * q, axis=-1), -q

        name = f"std_gauss_{dim}"
    else:
        var = jnp.logspace(0.0, 4.0, dim)  # kappa = 1e4

        def logp_grad(q):
            return -0.5 * jnp.sum(q * q / var, axis=-1), -q / var

        name = f"ill_gauss_{dim}"

    sd = jnp.ones(dim) if var is None else jnp.sqrt(var)

    def generated(q):
        qn = q / sd
        return jnp.stack([qn[..., 0], qn[..., -1],
                          jnp.sum(qn * qn, axis=-1)], axis=-1)

    return wt.targets.Target(
        logp=lambda q: logp_grad(q)[0], dim=dim, name=name,
        generated=generated, logp_grad=logp_grad)


def run_arm(arm, args):
    """One sampler arm in this process, chain-sharded over the mesh."""
    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.parallel import make_mesh, shard_chains
    from walnuts_tpu.diagnostics import ess

    dim, C = args.dim, args.chains
    t = make_target(arm, dim)
    mesh = make_mesh(args.devices)
    n_dev = len(mesh.devices.ravel())
    key = jax.random.PRNGKey(sum(map(ord, arm)))
    # exact stationary start (the question here is moment correctness
    # of the variant integrators, not transient behaviour)
    if arm.endswith("_std"):
        q0 = jax.random.normal(key, (C, dim), jnp.float32)
    else:
        sd = jnp.sqrt(jnp.logspace(0.0, 4.0, dim, dtype=jnp.float32))
        q0 = sd * jax.random.normal(key, (C, dim), jnp.float32)
    q0 = shard_chains(q0, mesh)

    h = 1.4 * dim ** -0.25
    t0 = time.perf_counter()
    if arm.startswith("im_"):
        cfg = wt.WalnutsConfig(m=args.m,
                               integrator="adapt_implicit_midpoint_d")
        wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False,
                             adapt_delta=False)
        state = None
        parts, dparts = [], []
        done = 0
        while done < args.iters:
            n = min(args.chunk, args.iters - done)
            s, dg, state = wt.run_walnuts(
                jax.random.fold_in(key, 7000 + done), q0, target=t,
                cfg=cfg, warmup=wu, num_iter=n, h0=h, delta0=0.3,
                resume_state=state)
            parts.append(np.asarray(s, np.float64)[1:])
            dparts.append(np.asarray(dg[..., 6]).sum()
                          + np.asarray(dg[..., 7]).sum())
            done += n
            print(f"{arm}: {done}/{args.iters}", flush=True)
        s = np.concatenate(parts)
        n_grad = float(np.sum(dparts))
    else:
        from walnuts_tpu.sampler import IsokineticKernel, run_generic_nuts

        s, dg = run_generic_nuts(
            jax.random.fold_in(key, 1), q0, target=t,
            kernel=IsokineticKernel(), h_macro=h, delta=0.2,
            num_iter=args.iters, m=args.m)
        s = np.asarray(s, np.float64)[1:]
        n_grad = float(np.asarray(dg[..., 7]).sum())
    dt = time.perf_counter() - t0

    # moment gates with ESS-based MC standard errors
    import jax.numpy as jnp2

    def zscore(x, true_mean, true_sd):
        e = max(float(np.asarray(ess(jnp2.asarray(x)))), 4.0)
        se = true_sd / np.sqrt(e)
        return float((x.mean() - true_mean) / se), e

    z0, e0 = zscore(s[..., 0], 0.0, 1.0)
    zl, el = zscore(s[..., 1], 0.0, 1.0)
    zr, er = zscore(s[..., 2], float(dim), float(np.sqrt(2 * dim)))
    # sd of the normalised coordinates should be 1
    sd0 = float(s[..., 0].std())
    res = {
        "arm": arm,
        "dim": dim,
        "chains": C,
        "devices": n_dev,
        "iters": args.iters,
        "H": h,
        "seconds": round(dt, 1),
        "grad_evals": n_grad,
        "grad_evals_per_s": round(n_grad / dt, 1),
        "z_mean_q0": z0, "ess_q0": e0,
        "z_mean_qlast": zl, "ess_qlast": el,
        "z_radius_sq": zr, "ess_radius_sq": er,
        "sd_q0": sd0,
        "radius_sq_mean": float(s[..., 2].mean()),
        "radius_sq_expected": float(dim),
    }
    print(json.dumps(res, default=float), flush=True)
    atomic_dump(res, args.frag)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--m", type=int, default=9)
    ap.add_argument("--out", default="examples/out_highdim_variants.json")
    ap.add_argument("--arm", default=None, help="subprocess mode")
    ap.add_argument("--frag", default=None)
    ap.add_argument("--arms", default=",".join(ARMS))
    args = ap.parse_args()

    if args.arm:
        run_arm(args.arm, args)
        return

    me = os.path.abspath(__file__)
    runs = {}
    for arm in args.arms.split(","):
        frag = f"/tmp/highdim_{arm}_{args.dim}.json"
        if not os.path.exists(frag):
            r = subprocess.run(
                [sys.executable, me, "--arm", arm, "--frag", frag,
                 "--dim", str(args.dim),
                 "--chains", str(args.chains),
                 "--iters", str(args.iters),
                 "--chunk", str(args.chunk),
                 "--m", str(args.m)]
                + (["--devices", str(args.devices)]
                   if args.devices else []))
            if r.returncode != 0:
                raise SystemExit(f"arm {arm} failed")
        with open(frag) as f:
            runs[arm] = json.load(f)
        zmax = max(abs(runs[arm][k]) for k in
                   ("z_mean_q0", "z_mean_qlast", "z_radius_sq"))
        runs[arm]["max_abs_z"] = zmax
        atomic_dump({"runs": runs}, args.out)

    worst = max(r["max_abs_z"] for r in runs.values())
    res = {"runs": runs, "max_abs_z_all": worst, "gate_z": 4.0}
    atomic_dump(res, args.out)
    print(json.dumps({k: round(r["max_abs_z"], 2)
                      for k, r in runs.items()}
                     | {"max_abs_z_all": round(worst, 2)}), flush=True)
    if worst >= 4.0:
        raise SystemExit("FAIL: a moment z-score exceeds 4")


if __name__ == "__main__":
    main()
