"""walnuts_tpu — a batched WALNUTS/NUTS inference engine in JAX.

A from-scratch re-design of the capabilities of bob-carpenter/walnuts
(the Within-orbit Adaptive step-Length No-U-Turn Sampler) for GPUs:
fixed-shape, masked, chain-batched orbit expansion under
``jit``; adaptive step-size refinement as masked ``lax.while_loop``
searches; warmup adaptation as scan carries; chains sharded over a
``jax.sharding.Mesh`` for multi-device / multi-host scale-out.
"""

__version__ = "0.1.0"

from . import targets, ops, sampler, utils, parallel, diagnostics
from .targets import Target
from .ops import IntegratorConfig
from .sampler import (
    WalnutsConfig,
    WarmupConfig,
    walnuts_transition,
    run_walnuts,
)

__all__ = [
    "targets",
    "ops",
    "sampler",
    "utils",
    "parallel",
    "diagnostics",
    "Target",
    "IntegratorConfig",
    "WalnutsConfig",
    "WarmupConfig",
    "walnuts_transition",
    "run_walnuts",
]
