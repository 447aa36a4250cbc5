"""Run the sampler's main path once on NVIDIA GPUs and check it.

    python chip_smoke.py             # one card: phases 0-3
    python chip_smoke.py --cards 4   # the chain-sharded mesh on four
                                     # cards, and its one-card comparison

All phases run in this one process and share one compile cache.

0. The card: ``nvidia-smi``'s name and power limit, JAX's device kind
   and count, the JAX version and the compile-cache directory.  Every
   later line starts with the card's name and power limit.
1. The plain reference at full width: funnel-101 log density, gradient
   and one leapfrog micro step on a seeded ``[8192, 101]`` float32
   batch, against NumPy in float64.
2. The fused engine at the bench's configuration (``bench.py``):
   pooled in-loop warmup, then ~100 draws per chain from exact draws
   of the funnel, streamed as round-capped invocations; compile time,
   memory, rates, the adapted (H, delta), and a gate on the exact
   marginal omega ~ N(0, 3^2).
3. The scan engine, called as the README's quick start calls it, with
   finite draws and diagnostics; omega is gated when the run is long
   enough to forget its start.

With ``--cards N`` only phase 2 runs: once with N x 8192 chains
sharded over an N-card mesh, and once with 8192 chains on card 0.

The last line of standard output is one JSON object, printed only when
every phase passed.  Without a GPU the script exits nonzero before any
phase.
"""

import argparse
import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import bench
import walnuts_tpu as wt
from bench import card_name_and_power, require_gpu
from walnuts_tpu.diagnostics import ess
from walnuts_tpu.ops.leapfrog import PhasePoint, leapfrog_step
from walnuts_tpu.parallel import make_mesh
from walnuts_tpu.sampler.megakernel import run_walnuts_fused
from walnuts_tpu.targets import reference
from walnuts_tpu.utils.compile_cache import use_compile_cache

WARMUP = 300          # pooled in-loop warmup transitions per chain
DRAWS = 100           # draws per chain after warmup
ROUNDS = 2500         # rounds per round-capped invocation
MAX_CALLS = 400       # invocations before a phase counts as stuck
SCAN_CHAINS = 1024
SCAN_WARMUP = 100
SCAN_DRAWS = 100
# |z| bound on omega's mean and sd; each z is the error over a
# standard error taken from the draws' own ESS
Z_MAX = 5.0
# the scan phase gates omega only when its draws span this many of
# omega's autocorrelation times
GATE_TAUS = 10
# phase-1 bound on |jax - numpy| / (1 + |numpy|): float32 has a 2^-24
# unit roundoff (6e-8), a 100-term sum taken in another order than
# NumPy's can lose ~100 of them, and exp(-omega) amplifies the input's
# own rounding by |omega| <= ~5 — so 1e-4 leaves ~10x headroom
REF_TOL = 1e-4


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


def phase_reference(chains=bench.CHAINS, dim=bench.DIM):
    """Funnel log density, gradient and one batched leapfrog micro step
    on the device against the NumPy float64 reference."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((chains, dim)).astype(np.float32)
    v = rng.standard_normal((chains, dim)).astype(np.float32)
    hh = rng.uniform(0.05, 0.3, chains).astype(np.float32)
    target = wt.targets.funnel(dim)

    def step(q, v, hh):
        lp, g = target.logp_grad(q)
        p, *_ = leapfrog_step(target, PhasePoint(q, v, g, lp), hh)
        return lp, g, p

    # no matmul on this path today; "highest" keeps a future target's
    # matmuls out of TF32
    with jax.default_matmul_precision("highest"):
        lp, g, p = jax.block_until_ready(jax.jit(step)(q, v, hh))
    q64, v64 = q.astype(np.float64), v.astype(np.float64)
    r_lp, r_g = reference.funnel_logp_grad(q64)
    r_q, r_v, r_g2, r_lp2 = reference.leapfrog(
        reference.funnel_logp_grad, q64, v64, r_g,
        hh.astype(np.float64)[:, None])
    errs = dict(
        err_logp=_rel_err(lp, r_lp), err_grad=_rel_err(g, r_g),
        err_step_q=_rel_err(p.q, r_q), err_step_v=_rel_err(p.v, r_v),
        err_step_grad=_rel_err(p.g, r_g2),
        err_step_logp=_rel_err(p.lp, r_lp2))
    return dict(chains=chains, dim=dim, tol=REF_TOL, **errs,
                ok=all(e <= REF_TOL for e in errs.values()))


def omega_gate(w):
    """Mean and sd of omega draws ``[N, C]`` against the exact N(0, 3^2),
    in standard errors from the draws' own ESS (the sd's from the ESS
    of the squared deviations: se(sd) = 3 / sqrt(2 ESS))."""
    w = np.asarray(w, np.float64)
    mean, sd = float(w.mean()), float(w.std())
    ess_mean = float(ess(jnp.asarray(w, jnp.float32)))
    ess_sq = float(ess(jnp.asarray((w - mean) ** 2, jnp.float32)))
    se_mean = 3.0 / math.sqrt(ess_mean)
    se_sd = 3.0 / math.sqrt(2.0 * ess_sq)
    z_mean, z_sd = mean / se_mean, (sd - 3.0) / se_sd
    return dict(omega_mean=mean, omega_sd=sd, ess_mean=ess_mean,
                ess_sq=ess_sq, se_mean=se_mean, se_sd=se_sd,
                z_mean=z_mean, z_sd=z_sd, z_max=Z_MAX,
                gate_ok=bool(np.all(np.isfinite(w))
                             and abs(z_mean) <= Z_MAX
                             and abs(z_sd) <= Z_MAX))


def funnel_draws(key, chains, dim):
    """Exact draws of Neal's funnel: omega ~ N(0, 3^2), then
    x | omega ~ N(0, e^omega)."""
    z = jax.random.normal(key, (chains, dim), jnp.float32)
    w = 3.0 * z[:, :1]
    return jnp.concatenate([w, jnp.exp(0.5 * w) * z[:, 1:]], axis=1)


def _chain_axis(leaf, C):
    return leaf.shape.index(C) if C in leaf.shape else None


def _placer(mesh, C):
    """Put every leaf of a state on ``mesh``: its chain axis (the first
    axis of length ``C``) split over the mesh, anything else
    replicated.  The resume variant is compiled for this placement, so
    that the state any invocation returns can be passed to the next."""
    def put(leaf):
        spec = [None] * leaf.ndim
        ax = _chain_axis(leaf, C)
        if ax is not None:
            spec[ax] = "chains"
        return jax.device_put(leaf, NamedSharding(mesh, P(*spec)))

    return lambda st: jax.tree.map(put, st)


def _stream(until, place, key, q0, h, d, **kw):
    """Compile one fused-engine program (its fresh and its resume
    variant) and run round-capped invocations until every chain has
    ``until`` transitions.  ``place`` puts the carried state where the
    resume variant expects it.  Returns the last invocation's state,
    the compile seconds, the resume variant's memory analysis and the
    seconds the invocations took, each ended by
    ``block_until_ready``."""
    t0 = time.perf_counter()
    fresh = run_walnuts_fused.lower(key, q0, h, d, **kw).compile()
    compile_s = time.perf_counter() - t0
    resume, st, run_s = None, None, 0.0
    for _ in range(MAX_CALLS):
        if st is not None and resume is None:
            t0 = time.perf_counter()
            resume = run_walnuts_fused.lower(
                key, q0, h, d, mk_state=place(st), **kw).compile()
            compile_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = (fresh(key, q0, h, d) if st is None
               else resume(key, q0, h, d, mk_state=place(st)))
        st = jax.block_until_ready(out[-1])
        run_s += time.perf_counter() - t0
        if int(np.asarray(st.it).min()) >= until:
            mem = (resume or fresh).memory_analysis()
            return st, compile_s, mem, run_s
    raise RuntimeError(f"fused engine: {MAX_CALLS} invocations of "
                       f"{kw['rounds']} rounds left chains short of "
                       f"{until} transitions")


def _shards_ok(st, n_dev, C):
    """Every leaf of the state that has a chain axis holds ``C / n_dev``
    chains on each of ``n_dev`` distinct devices."""
    for leaf in jax.tree.leaves(st):
        ax = _chain_axis(leaf, C)
        if ax is None:
            continue
        shards = leaf.addressable_shards
        if (len(shards) != n_dev
                or len({s.device for s in shards}) != n_dev
                or any(s.data.shape[ax] != C // n_dev for s in shards)):
            return False
    return True


def _mb(n):
    return round(n / 2 ** 20, 1)


def phase_fused(chains=bench.CHAINS, dim=bench.DIM, warmup=WARMUP,
                draws=DRAWS, mesh=None):
    """The fused engine at the bench's configuration, its chains
    sharded over ``mesh`` when one is given: pooled in-loop warmup from
    the bench's start, then ``draws`` draws per chain at the adapted
    (H, delta).

    The draws start from fresh exact draws of the funnel, not from
    where warmup left the chains: warmup moves omega away from its
    marginal, and omega's autocorrelation time on funnel-101 is
    longer than ``draws``, so draws from warmup's end would gate the
    warmup's transient.  From exact draws every draw of a correct
    engine is exactly N(0, 3^2) in omega.  Where warmup left omega is
    reported beside the gate."""
    target = wt.targets.funnel(dim, generated=lambda q: jnp.stack(
        [q[..., 0], jnp.sum(q[..., 1:] ** 2, axis=-1)], axis=-1))
    cfg = wt.WalnutsConfig(m=bench.M)
    q0 = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (chains, dim),
                                 jnp.float32)
    h = jnp.full((chains,), bench.H0, jnp.float32)
    d = jnp.full((chains,), bench.DELTA0, jnp.float32)
    place = lambda st: st  # noqa: E731
    if mesh is not None:
        place = _placer(mesh, chains)
        q0, h, d = place((q0, h, d))
    common = dict(target=target, cfg=cfg, rng="hash", rounds=ROUNDS,
                  micro_unroll=bench.MICRO_UNROLL,
                  stop_mode="min_per_chain")

    wst, wu_compile, _, wu_s = _stream(
        warmup, place, jax.random.PRNGKey(1), q0, h, d,
        num_iter=warmup, ring_rows=8, diag_rows=8,
        warmup=wt.WarmupConfig(warmup_iter=warmup, pooled=True),
        **common)
    q1 = funnel_draws(jax.random.PRNGKey(2), chains, dim)
    st, compile_s, mem, run_s = _stream(
        draws, place, jax.random.PRNGKey(3),
        *place((q1, wst.h_cur, wst.delta_cur)),
        num_iter=draws, diag_rows=8, **common)

    grads = int(np.asarray(st.grad_ct, np.int64).sum())
    rounds_run = int(np.asarray(st.n))
    out = dict(
        chains=chains, dim=dim, devices=1 if mesh is None else mesh.size,
        warmup_compile_s=wu_compile, warmup_s=wu_s,
        adapted_h=float(np.median(np.asarray(wst.h_cur))),
        adapted_delta=float(np.median(np.asarray(wst.delta_cur))),
        warmup_end_omega_mean=float(np.asarray(wst.qc[:, 0]).mean()),
        warmup_end_omega_sd=float(np.asarray(wst.qc[:, 0]).std()),
        compile_s=compile_s, sample_s=run_s, rounds=rounds_run,
        grad_evals=grads, grad_evals_per_s=grads / run_s,
        rounds_per_s=rounds_run / run_s,
        draws_per_chain_min=int(np.asarray(st.it).min()))
    if mem is not None:
        out.update(mem_args_mb=_mb(mem.argument_size_in_bytes),
                   mem_out_mb=_mb(mem.output_size_in_bytes),
                   mem_temp_mb=_mb(mem.temp_size_in_bytes),
                   mem_alias_mb=_mb(mem.alias_size_in_bytes))
    out.update(omega_gate(np.asarray(st.samples)[..., 0]))
    out["shards_ok"] = (True if mesh is None
                        else _shards_ok(st, mesh.size, chains))
    out["ok"] = out["gate_ok"] and out["shards_ok"]
    out["state"] = st
    return out


def phase_scan(chains=SCAN_CHAINS, dim=bench.DIM, warmup=SCAN_WARMUP,
               draws=SCAN_DRAWS):
    """``wt.run_walnuts`` as the README's quick start calls it, from its
    start near the origin.  Omega is gated only when the draws are many
    autocorrelation times long (``GATE_TAUS``), so that the start is
    forgotten; otherwise its moments are printed with the reason."""
    target = wt.targets.funnel(dim)
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (chains, dim),
                                 jnp.float32)
    key = jax.random.PRNGKey(1)
    kw = dict(target=target,
              cfg=wt.WalnutsConfig(m=10, integrator="adapt_leapfrog_r2p"),
              warmup=wt.WarmupConfig(warmup_iter=warmup),
              num_iter=warmup + draws)
    t0 = time.perf_counter()
    compiled = wt.run_walnuts.lower(key, q0, h0=0.3, delta0=0.3,
                                    **kw).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, diagnostics, state = jax.block_until_ready(
        compiled(key, q0, h0=0.3, delta0=0.3))
    run_s = time.perf_counter() - t0
    samples, diagnostics = np.asarray(samples), np.asarray(diagnostics)
    finite = bool(np.all(np.isfinite(samples))
                  and np.all(np.isfinite(diagnostics)))
    out = dict(chains=chains, dim=dim, warmup=warmup, draws=draws,
               compile_s=compile_s, run_s=run_s,
               transitions_per_s=chains * (warmup + draws) / run_s,
               finite=finite)
    out.update(omega_gate(samples[warmup + 1:, :, 0]))
    # integrated autocorrelation time of omega, in transitions
    out["tau"] = chains * draws / out["ess_mean"]
    out["gated"] = draws >= GATE_TAUS * out["tau"]
    if not out["gated"]:
        out["not_gated_because"] = (
            f"{draws} draws are {draws / out['tau']:.2f} autocorrelation "
            f"times of omega, fewer than {GATE_TAUS} needed to forget "
            f"the start")
    out["ok"] = finite and (out["gate_ok"] or not out["gated"])
    return out


def phase_mesh(n_cards, chains_per_card=bench.CHAINS, **kw):
    """Phase 2 on an ``n_cards`` chain mesh, and on card 0 alone."""
    one = phase_fused(chains_per_card, **kw)
    many = phase_fused(n_cards * chains_per_card,
                       mesh=make_mesh(n_cards), **kw)
    return dict(one_card=one, mesh=many,
                rate_ratio=many["grad_evals_per_s"]
                / one["grad_evals_per_s"],
                ok=one["ok"] and many["ok"])


def _report(card, phase, fields):
    shown = {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in fields.items()
             if isinstance(v, (bool, int, float, str))}
    print(f"[{card}] {phase}: {json.dumps(shown)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the chain-sharded mesh phase on "
                         "this many cards (default: 1 card, all phases)")
    args = ap.parse_args(argv)

    require_gpu(args.cards)
    smi = card_name_and_power()
    card = smi.splitlines()[0]
    cache = use_compile_cache()
    dev = jax.devices()[0]
    print(smi, flush=True)
    _report(card, "card", dict(
        device_kind=dev.device_kind, device_count=len(jax.devices()),
        jax=jax.__version__, compile_cache=cache,
        xla_flags=os.environ.get("XLA_FLAGS", "")))

    ok = True
    if args.cards == 1:
        for name, fn in (("reference", phase_reference),
                         ("fused", phase_fused), ("scan", phase_scan)):
            res = fn()
            _report(card, name, res)
            ok = ok and res["ok"]
    else:
        res = phase_mesh(args.cards)
        _report(card, "mesh: one card", res["one_card"])
        _report(card, f"mesh: {args.cards} cards", res["mesh"])
        _report(card, "mesh", res)
        ok = res["ok"]
    if not ok:
        print("chip_smoke: a phase failed its check", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
