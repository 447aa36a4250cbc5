"""Two-process ``jax.distributed`` smoke test (VERDICT r2 item 6).

Executes the multi-process init + cross-process mesh path that a
multi-host deployment would use (``parallel/mesh.py:distributed_init``):
two spawned CPU processes initialise ``jax.distributed`` over local
TCP, build ONE global 2-device mesh whose devices live in different
processes, run a chain-sharded WALNUTS step over it with ``pjit``, and
cross-check a ``psum`` collective — the same primitives the pooled
warmup consensus and cross-chain diagnostics ride in production.

The whole test runs in subprocesses so the main pytest process (whose
jax is already initialised single-process) is untouched.
"""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1])
sys.path.insert(0, os.getcwd())

import jax
from walnuts_tpu.parallel.mesh import distributed_init

distributed_init(coordinator="127.0.0.1:{port}", num_processes=2,
                 process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()  # global view
assert len(jax.local_devices()) == 1

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import walnuts_tpu as wt
from walnuts_tpu.parallel.mesh import make_mesh

mesh = make_mesh(2)                      # global mesh, 2 processes
sh = NamedSharding(mesh, P("chains", None))

C, D = 8, 6
t = wt.targets.std_gauss(D)

# each process contributes its local shard of the chain batch
local = 0.1 * np.arange(C // 2 * D, dtype=np.float32).reshape(
    C // 2, D) + pid
q0 = jax.make_array_from_single_device_arrays(
    (C, D), sh, [jax.device_put(local, jax.local_devices()[0])])

# a chain-sharded WALNUTS sampling step compiles + executes SPMD
cfg = wt.WalnutsConfig(m=3)
wu = wt.WarmupConfig(warmup_iter=0, adapt_h=False, adapt_delta=False)
s, d, st = wt.run_walnuts(jax.random.PRNGKey(0), q0, target=t,
                          cfg=cfg, warmup=wu, num_iter=3, h0=0.5,
                          delta0=0.2)
jax.block_until_ready(s)
assert s.shape == (4, C, D)

# cross-process collective: psum over the chain axis (the pooled
# warmup consensus primitive)
def pooled(x):
    return jax.lax.psum(jnp.sum(x), "chains")


tot = jax.jit(jax.shard_map(pooled, mesh=mesh, in_specs=P("chains", None),
                            out_specs=P()))(q0)
expect = float(np.sum(local)) + float(
    np.sum(local - pid + (1 - pid)))   # other process's shard
np.testing.assert_allclose(float(tot), expect, rtol=1e-5)
print(f"proc {pid} OK", flush=True)
"""


def test_two_process_distributed_mesh(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("{port}", str(port)))
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    })
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid)],
                         env=env, cwd=os.getcwd(),
                         stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out
