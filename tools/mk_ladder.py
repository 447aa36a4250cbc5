"""Megakernel throughput ladder: grad-evals/s vs micro_unroll K.

Measures the funnel-101 bench configuration (C=8192, f32, adapted
tuning) at K in {1, 2, 4, 8} with round-capped streaming invocations,
printing one JSON line per rung.  Used to pick bench.py's production
K; not yet run on the H100.

Usage: python tools/mk_ladder.py [--chains 8192] [--seconds 20]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=101)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warmup-iters", type=int, default=200)
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--rus", type=int, nargs="+", default=[1],
                    help="round_unroll values to cross with --ks "
                         "(full-body unroll; bitwise-identical "
                         "stream, pure XLA fusion lever)")
    ap.add_argument("--rounds", type=int, default=2500)
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

    # short in-loop warmup so every rung runs at realistic tuning
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
    }), flush=True)

    for K in args.ks:
      for U in args.rus:
        kw2 = dict(target=target, cfg=cfg, num_iter=1 << 30,
                   stop_mode="min_per_chain", ring_rows=8, diag_rows=8,
                   rng="hash", rounds=args.rounds, micro_unroll=K,
                   round_unroll=U)
        # compile fresh + resume variants before timing
        out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t, d_t,
                                **kw2)
        jax.block_until_ready(out[0])
        stt = out[-1]
        out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t, d_t,
                                mk_state=stt, **kw2)
        jax.block_until_ready(out[0])
        stt = out[-1]

        g0 = int(np.asarray(stt.grad_ct, np.int64).sum())
        n0 = int(np.asarray(stt.n).max()) if np.ndim(stt.n) else int(stt.n)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            out = run_walnuts_fused(jax.random.PRNGKey(2), q1, h_t,
                                    d_t, mk_state=stt, **kw2)
            stt = out[-1]
            jax.block_until_ready(stt.grad_ct)
        dt = time.perf_counter() - t0
        g1 = int(np.asarray(stt.grad_ct, np.int64).sum())
        n1 = int(np.asarray(stt.n).max()) if np.ndim(stt.n) else int(stt.n)
        rounds = max(n1 - n0, 1)
        print(json.dumps({
            "K": K,
            "RU": U,
            "grad_evals_per_s": round((g1 - g0) / dt, 1),
            "rounds_per_s": round(rounds / dt, 1),
            "grads_per_round_per_chain": round(
                (g1 - g0) / rounds / C, 4),
            "seconds": round(dt, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
