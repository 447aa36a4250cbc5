"""Device mesh construction and chain sharding.

The sampler is written in plain batched jnp over a leading ``chains``
axis; placing inputs with a ``NamedSharding(mesh, P('chains', ...))``
makes XLA partition every op in the transition SPMD across devices
with no cross-device communication in the hot loop (chains never
interact inside a transition).  This module centralises the placement
rules so drivers and the compile-check entry points share them.
"""

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialise multi-host JAX (no-op on a single host).

    Nothing tells JAX of a cluster on its own here: give the
    coordinator's ``host:port``, the number of processes and this
    process's id explicitly.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def make_mesh(n_devices: Optional[int] = None, axis: str = "chains") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (axis,))


def make_mesh2(n_chain: int, n_dim: int,
               axes=("chains", "dim")) -> Mesh:
    """A 2-D ``(chains, dim)`` mesh: chains data-parallel AND the
    parameter dimension tensor-parallel (SURVEY §2.6 TP row).

    With ``[C, D]`` state placed as ``P('chains', 'dim')``, XLA's SPMD
    partitioner turns every D-reduction in the hot loop — the kinetic
    energies ``sum(v*v)`` and the U-turn inner products
    ``sum(v*(qp-qm))`` — into ``psum`` collectives over the ``dim``
    axis, which is the explicit comm structure the reference never
    had.  Worth it only for D >> 1e4 targets where a chain's state
    no longer fits comfortably per device.
    """
    devs = jax.devices()
    need = n_chain * n_dim
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    import numpy as np

    return Mesh(np.asarray(devs[:need]).reshape(n_chain, n_dim), axes)


def shard_chains_dim(x, mesh: Mesh, axes=("chains", "dim")):
    """Place ``[C, D]``-shaped leaves as ``P(chains, dim)`` (both axes
    sharded); ``[C]`` leaves chain-sharded; scalars replicated."""

    def _put(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim == 0:
            return jax.device_put(leaf, NamedSharding(mesh, P()))
        if leaf.ndim == 1:
            return jax.device_put(
                leaf, NamedSharding(mesh, P(axes[0])))
        spec = P(axes[0], *([None] * (leaf.ndim - 2)), axes[1])
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(_put, x)


def shard_chains(x, mesh: Mesh, axis: str = "chains"):
    """Place an array (or pytree) with its leading axis sharded over the
    mesh; scalars and rank-0 leaves are replicated."""

    def _put(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim == 0:
            return jax.device_put(leaf, NamedSharding(mesh, P()))
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(_put, x)


def replicate(x, mesh: Mesh):
    """Replicate an array (or pytree) across the mesh."""
    return jax.tree.map(
        lambda leaf: jax.device_put(
            jnp.asarray(leaf),
            NamedSharding(mesh, P(*([None] * jnp.asarray(leaf).ndim))),
        ),
        x,
    )


def shard_sampler_state(state, mesh: Mesh, axis: str = "chains"):
    """Shard a ``SamplerState`` chains-first: every leaf with a leading
    chain axis is sharded, the iteration counter is replicated."""

    def _put(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim == 0:
            return jax.device_put(leaf, NamedSharding(mesh, P()))
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(_put, state)
