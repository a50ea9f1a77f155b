"""Device mesh construction and sharding helpers.

First-class replacement for the reference's in-process scaling scaffolding
(utils/concurrency.py thread pools, utils/scaling.py AutoScaler/LoadBalancer,
utils/scalable_environment.py - SURVEY.md section 2.5): on the accelerator, scale-out is
a device mesh with the env batch sharded across chips. Every env is
independent, so the hot loop needs ZERO cross-chip collectives; ICI is used
only for metric reductions (psum of returns/success counts) and optional
tensor-parallel sharding of policy networks.

Mesh axes:
  * 'data'  - env batch axis (pure data parallel; always present)
  * 'model' - optional tensor-parallel axis for large policy networks
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a ('data', 'model') mesh over the available devices.

    Defaults to all devices on the data axis. Works identically for 1 chip,
    one host, or a multi-host pod slice (call jax.distributed.initialize
    first on pods - see parallel/distributed.py).
    """
    if devices is None:
        devices = jax.devices()
    n_total = len(devices)
    if n_data is None:
        n_data = n_total // n_model
    if n_data * n_model != n_total:
        raise ValueError(
            f"mesh {n_data}x{n_model} != {n_total} available devices"
        )
    dev_array = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(dev_array, ("data", "model"))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (B, ...) env state arrays: batch split over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_state(state, mesh: Mesh):
    """Place an EnvState pytree on the mesh: batch-major arrays sharded over
    'data', scalars/keys replicated."""
    batch_shard = env_sharding(mesh)
    repl = replicated(mesh)

    def place(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1 and x.shape[0] % mesh.shape["data"] == 0 and x.shape[0] > 1:
            return jax.device_put(x, batch_shard)
        return jax.device_put(x, repl)

    return jax.tree.map(place, state)


def shard_batch(x, mesh: Mesh):
    """Place a (B, ...) array with the batch axis split over 'data'."""
    return jax.device_put(x, env_sharding(mesh))


def pmean_metrics(tree, mesh: Mesh):
    """Mean-reduce each metric leaf to a scalar replicated across the mesh.

    Host-callable: leaves may be batch-sharded over 'data' (the usual case
    for per-env metrics) or replicated; either way the result is the global
    mean, computed on-device with XLA-inserted all-reduce collectives and
    placed replicated so every chip (and the host) sees the same scalar.
    """
    import jax.numpy as jnp

    reduce_all = jax.jit(
        lambda t: jax.tree.map(jnp.mean, t),
        out_shardings=replicated(mesh),
    )
    return reduce_all(tree)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n
