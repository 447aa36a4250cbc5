"""Megakernel round-cost ablation profile (VERDICT r4 item 3).

When rounds/s is nearly flat in micro_unroll K (tools/mk_ladder.py),
a gradient eval is a small share of a round and the round is mostly
bookkeeping.  This tool measures WHERE that bookkeeping cost sits by
timing the same
warmup-adapted funnel-101 configuration with named cost centres
ablated (semantics intentionally broken; only rounds/s is read):

* ``full``       — the production body
* ``no_slab``    — span-slab store + merge U-turn check removed
                   (the only [C, S, D] traffic in the round)
* ``no_stage``   — diagnostics-row stack + sample/diag staging
                   writes removed
* ``no_both``
* ``integrator`` — a bare masked-leapfrog while_loop over the same
                   [C, D] state and target (the speed-of-light
                   reference: what a round would cost if it carried
                   only the integration state)

Also crosses round_unroll U in {1, 2, 4} on the full body: U chains
complete round bodies inside one fori iteration so XLA can fuse
across round boundaries (identical algorithm + RNG stream).

Usage: python tools/profile_round.py [--chains 8192] [--seconds 15]
Writes one JSON line per configuration.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def integrator_only(key, q0, h, n_rounds, target):
    """Bare masked-leapfrog loop: the round's speed-of-light."""
    import jax
    import jax.numpy as jnp

    lp0, g0 = target.logp_grad(q0)

    @jax.jit
    def run(q, v, g, hh):
        def body(i, c):
            q, v, g = c
            vh = v + 0.5 * hh[:, None] * g
            q2 = q + hh[:, None] * vh
            lp2, g2 = target.logp_grad(q2)
            v2 = vh + 0.5 * hh[:, None] * g2
            return (q2, v2, g2)

        return jax.lax.fori_loop(0, n_rounds, body, (q, v, g))

    v0 = jax.random.normal(key, q0.shape, q0.dtype)
    out = run(q0, v0, g0, h)
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    out = run(q0, v0, g0, h)
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    return n_rounds / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=101)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--warmup-iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2500)
    ap.add_argument("--k", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import walnuts_tpu as wt
    from walnuts_tpu.sampler.megakernel import run_walnuts_fused

    target = wt.targets.funnel(
        args.dim, generated=lambda q: q[..., :1])
    C = args.chains
    cfg = wt.WalnutsConfig(m=8)
    q0 = 0.3 * jax.random.normal(jax.random.PRNGKey(0),
                                 (C, args.dim), jnp.float32)
    h_t = jnp.full((C,), 0.3, jnp.float32)
    d_t = jnp.full((C,), 0.3, jnp.float32)

    wu = wt.WarmupConfig(warmup_iter=args.warmup_iters, pooled=True)
    stt = None
    kw = dict(target=target, cfg=cfg, num_iter=args.warmup_iters,
              warmup=wu, ring_rows=8, rng="hash", rounds=args.rounds)
    while True:
        out = run_walnuts_fused(jax.random.PRNGKey(1), q0, h_t, d_t,
                                mk_state=stt, **kw)
        stt = out[-1]
        if int(np.asarray(stt.it).min()) >= args.warmup_iters:
            break
    q1, h_t, d_t = stt.qc, stt.h_cur, stt.delta_cur
    print(json.dumps({
        "adapted_h_median": float(np.median(np.asarray(h_t))),
        "adapted_delta_median": float(np.median(np.asarray(d_t))),
        "chains": C, "dim": args.dim, "micro_unroll": args.k,
    }), flush=True)

    # speed-of-light reference at the adapted step size
    r_int = integrator_only(jax.random.PRNGKey(9), q1, h_t, 2000,
                            target)
    print(json.dumps({
        "config": "integrator_only", "rounds_per_s": round(r_int, 1),
        "grad_evals_per_s": round(r_int * C, 1),
    }), flush=True)

    cases = [
        ("full", (), 1),
        ("no_slab", ("slab",), 1),
        ("no_stage", ("stage",), 1),
        ("no_both", ("slab", "stage"), 1),
        ("full_U2", (), 2),
        ("full_U4", (), 4),
    ]
    for name, ab, ru in cases:
        kw2 = dict(target=target, cfg=cfg, num_iter=1 << 30,
                   stop_mode="min_per_chain", ring_rows=8, diag_rows=8,
                   rng="hash", rounds=args.rounds,
                   micro_unroll=args.k, round_unroll=ru, ablate=ab)
        out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t, d_t,
                                **kw2)
        jax.block_until_ready(out[0])
        stt = out[-1]
        out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t, d_t,
                                mk_state=stt, **kw2)
        jax.block_until_ready(out[0])
        stt = out[-1]
        g0 = int(np.asarray(stt.grad_ct, np.int64).sum())
        n0 = int(np.asarray(stt.n))
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t,
                                    d_t, mk_state=stt, **kw2)
            stt = out[-1]
            jax.block_until_ready(stt.grad_ct)
        dt = time.perf_counter() - t0
        g1 = int(np.asarray(stt.grad_ct, np.int64).sum())
        n1 = int(np.asarray(stt.n))
        rounds = max(n1 - n0, 1)
        print(json.dumps({
            "config": name,
            "rounds_per_s": round(rounds / dt, 1),
            "us_per_round": round(1e6 * dt / rounds, 1),
            "grad_evals_per_s": round((g1 - g0) / dt, 1),
            "grads_per_round_per_chain": round(
                (g1 - g0) / rounds / C, 4),
            "seconds": round(dt, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
