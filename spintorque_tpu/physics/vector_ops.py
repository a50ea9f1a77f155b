"""Batched magnetics vector operations.

Counterpart of the reference's vectorized-NumPy tier
(spin_torque_gym/utils/vectorized_operations.py:15-499 - its batched Euler
solver is subsumed by physics/integrator.py, which also carries the
spin-torque term the reference's batched RHS silently drops, :172-220).
These are the standalone batched primitives (cross/dot/normalize/energy/
TMR-resistance) as jitted jnp functions over (..., 3) arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import MU0


@jax.jit
def batch_cross(a, b):
    """Cross product over (..., 3) batches."""
    return jnp.cross(a, b)


@jax.jit
def batch_dot(a, b):
    """Dot product over (..., 3) -> (...)."""
    return jnp.sum(a * b, axis=-1)


@jax.jit
def batch_normalize(v, eps: float = 1e-12):
    """Safe normalization over (..., 3)."""
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(norm, eps)


@jax.jit
def batch_magnetic_energy(m, h_applied, ms, k_u, volume, easy_axis):
    """Zeeman + uniaxial energy per device (vectorized_operations.py:340-368)."""
    e = batch_normalize(jnp.asarray(easy_axis))
    zeeman = -MU0 * ms * volume * batch_dot(m, h_applied)
    anis = -k_u * volume * batch_dot(m, e) ** 2
    return zeeman + anis


@jax.jit
def batch_tmr_resistance(m, reference_m, r_p, r_ap):
    """TMR cosine resistance over batches (vectorized_operations.py:370-393)."""
    cos_theta = batch_dot(m, batch_normalize(jnp.asarray(reference_m)))
    r = r_p * (1.0 + ((r_ap - r_p) / r_p) * (1.0 - cos_theta) / 2.0)
    return jnp.maximum(r, 0.5 * r_p)


@jax.jit
def batch_anisotropy_field(m, ms, k_u, easy_axis):
    """H_anis = (2 K_u / mu0 Ms) (m.e) e over batches."""
    e = batch_normalize(jnp.asarray(easy_axis))
    h_k = 2.0 * k_u / (MU0 * ms)
    return (h_k * batch_dot(m, e))[..., None] * e


@jax.jit
def batch_demag_field_thin_film(m, ms):
    """Thin-film H_demag = -Ms m_z z_hat over batches."""
    out = jnp.zeros_like(m)
    return out.at[..., 2].set(-ms * m[..., 2])


def benchmark_batch_ops(batch_size: int = 4096, iters: int = 100):
    """Self-benchmark mirroring vectorized_operations.py:418-461."""
    import time

    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (batch_size, 3), jnp.float32)
    b = jax.random.normal(jax.random.fold_in(key, 1), (batch_size, 3), jnp.float32)
    out = batch_cross(a, b)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = batch_normalize(batch_cross(a, b))
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0
    return {
        "batch_size": batch_size,
        "iters": iters,
        "total_s": elapsed,
        "ops_per_s": batch_size * iters / elapsed,
    }
