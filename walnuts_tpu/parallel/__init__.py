"""Multi-device / multi-host scale-out (the layer the reference never
had — SURVEY.md §2.6: zero distributed code in bob-carpenter/walnuts).

Chains are the data-parallel axis: a ``[C, D]`` batch is sharded over a
1-D ``('chains',)`` mesh (the cards of a host, or several hosts), and
every per-chain computation in the sampler is embarrassingly parallel,
so jit + sharded inputs scale without any code changes.  Collectives
appear only in

* cross-chain pooled warmup adaptation (``pooled_quantile``), and
* cross-chain diagnostics (Rhat, ESS) in :mod:`walnuts_tpu.diagnostics`.
"""

from .mesh import (
    make_mesh,
    make_mesh2,
    shard_chains,
    shard_chains_dim,
    shard_sampler_state,
    replicate,
    distributed_init,
)

__all__ = [
    "make_mesh",
    "make_mesh2",
    "shard_chains",
    "shard_chains_dim",
    "shard_sampler_state",
    "replicate",
    "distributed_init",
]
