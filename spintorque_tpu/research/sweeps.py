"""Mesh-sharded parameter sweeps for the research tier.

Production-scale device characterization: thermal switching-probability
phase diagrams over (current, duration) grids with per-point stochastic
ensembles, and anisotropy/temperature ladders via the integrator's per-env
parameter support. The reference runs such sweeps as nested host loops
(e.g. the temperature sweep at thermal_model.py:274-336, the switching
studies in research/); here the WHOLE grid x ensemble is one batch through
the pulse integrator - the same GPU kernel as the RL envs - and the
batch axis shards over a ('data','model') mesh, so N cards evaluate
N-card-sized diagrams with zero cross-chip traffic until the final
ensemble reduction (computed locally per point; points never straddle
shards when sizes divide the mesh).

ROADMAP item "Mesh-sharded parameter sweeps" (round 4).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..physics.integrator import IntegratorConfig, integrate_pulse
from ..physics.llgs import LLGSParams


def _flat_grid(currents, durations, n_ensemble, dtype):
    currents = jnp.asarray(currents, dtype)
    durations = jnp.asarray(durations, dtype)
    jj, tt = jnp.meshgrid(currents, durations, indexing="ij")
    j_flat = jnp.repeat(jj.reshape(-1), n_ensemble)
    t_flat = jnp.repeat(tt.reshape(-1), n_ensemble)
    return currents, durations, j_flat, t_flat


def _tilted_m0(B, dtype, sign=-1.0):
    """Initial state in the ``sign`` well with a 0.5 degree polar tilt:
    exactly +-z is a torque fixed point, so a cold pole start would make
    the deterministic part of switching invisible."""
    tilt = jnp.asarray(jnp.sin(jnp.deg2rad(0.5)), dtype)
    mz0 = jnp.asarray(jnp.sign(sign), dtype) * jnp.sqrt(1.0 - tilt**2)
    return (
        jnp.full((B,), tilt, dtype),
        jnp.zeros((B,), dtype),
        jnp.full((B,), mz0, dtype),
    ), mz0


def _maybe_shard(mesh, data_axis, *arrays):
    """device_put the (B,) arrays with the batch split over ``data_axis``
    when a mesh is given and B divides it; otherwise return them unchanged
    (integrate_pulse_pallas falls back safely for indivisible batches)."""
    if mesh is None:
        return arrays
    B = arrays[0].shape[0]
    if B % mesh.shape[data_axis]:
        return arrays
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P(data_axis))
    return tuple(jax.device_put(a, shard) for a in arrays)


def _ensemble_stats(switched, failed, *lead_shape):
    """(p_switch, failed_fraction) per grid point; failed trajectories are
    EXCLUDED from the switching denominator (counting them as non-switching
    would report a confident p=0 for a fully-failed point - review
    finding). A point whose whole ensemble failed reports p_switch=nan."""
    switched = switched.reshape(*lead_shape, -1)
    failed = failed.reshape(*lead_shape, -1)
    valid = (~failed).sum(axis=-1)
    p = jnp.where(
        valid > 0,
        switched.sum(axis=-1) / jnp.maximum(valid, 1),
        jnp.nan,
    )
    return p, failed.mean(axis=-1)


def switching_probability_diagram(
    params: LLGSParams,
    currents,
    durations,
    n_ensemble: int = 256,
    temperature: float = 300.0,
    key: Optional[jax.Array] = None,
    method: str = "heun",
    noise_mode: str = "physical",
    max_substeps: Optional[int] = None,
    initial_mz: float = -1.0,
    mesh=None,
    data_axis: str = "data",
    use_pallas: Optional[bool] = None,
) -> Dict[str, jnp.ndarray]:
    """P(switch) over a (current, duration) grid with thermal ensembles.

    Starts every trajectory in the ``initial_mz`` well (default -z, with a
    0.5 degree tilt so deterministic torque is nonzero at the pole) and
    reports the fraction of the ensemble that ends with sign(m_z) flipped.
    One ``integrate_pulse`` call covers the whole grid x ensemble; with a
    mesh, the batch shards over ``data_axis`` and the GPU kernel runs per
    shard (ops/pallas_integrator.py).

    Returns {"currents", "durations", "p_switch" (nJ, nT), "final_mz"}.
    """
    dtype = jnp.float32
    if key is None:
        key = jax.random.PRNGKey(0)
    currents, durations, j_flat, t_flat = _flat_grid(
        currents, durations, n_ensemble, dtype
    )
    B = j_flat.shape[0]
    n_j, n_t = currents.shape[0], durations.shape[0]

    if max_substeps is None:
        from ..physics.integrator import max_substeps_for

        max_substeps = max_substeps_for(float(jnp.max(durations)))
    if use_pallas is None or use_pallas:
        from ..ops.pallas_integrator import pallas_supported, select_kernel

        cfg_probe = IntegratorConfig(
            method=method, thermal=True, noise_mode=noise_mode,
            max_substeps=max_substeps,
        )
        use_pallas = select_kernel(
            use_pallas, pallas_supported(params, cfg_probe, dtype)
        )
    config = IntegratorConfig(
        method=method,
        max_substeps=int(max_substeps),
        thermal=temperature > 0.0,
        noise_mode=noise_mode,
        use_pallas=bool(use_pallas),
        rk4_noise="per_substep",
    )

    m0, mz0 = _tilted_m0(B, dtype, sign=initial_mz)

    @jax.jit
    def run(m0, t_flat, j_flat, key):
        res = integrate_pulse(
            m0, span=t_flat, current=j_flat, params=params, config=config,
            key=key, temperature=jnp.asarray(temperature, dtype),
            mesh=mesh, data_axis=data_axis,
        )
        mx, my, mz = res.m
        # Strict sign flip: mz ending exactly at 0.0 has not crossed into
        # the opposite well, so it must not count (review finding; a sign()
        # inequality would count sign 0 as switched).
        switched = (mz * mz0 < 0.0) & ~res.failed
        p, failed_frac = _ensemble_stats(switched, res.failed, n_j, n_t)
        return p, failed_frac, mz

    *m0, t_flat, j_flat = _maybe_shard(mesh, data_axis, *m0, t_flat, j_flat)
    p_switch, failed_fraction, final_mz = run(tuple(m0), t_flat, j_flat, key)
    return {
        "currents": currents,
        "durations": durations,
        "p_switch": p_switch,
        "failed_fraction": failed_fraction,
        "final_mz": final_mz,
    }


def parameter_ladder_sweep(
    base_params: LLGSParams,
    vary: Dict[str, jnp.ndarray],
    current: float,
    duration: float,
    n_ensemble: int = 128,
    temperature: float = 300.0,
    key: Optional[jax.Array] = None,
    method: str = "heun",
    noise_mode: str = "physical",
    mesh=None,
    data_axis: str = "data",
) -> Dict[str, jnp.ndarray]:
    """Switching probability along ladders of DEVICE parameters.

    ``vary`` maps LLGSParams field names (e.g. 'uniaxial_anisotropy',
    'damping', 'volume') to equal-length value arrays; entry i of each
    ladder is evaluated with an ``n_ensemble`` thermal ensemble. Uses the
    integrator's per-env (B,) parameter support, so the whole ladder is
    ONE batch - no per-point recompiles or host loop - and shards like the
    grid sweep above.
    """
    dtype = jnp.float32
    if key is None:
        key = jax.random.PRNGKey(0)
    names = list(vary)
    if not names:
        raise ValueError("parameter_ladder_sweep: vary must name at least "
                         "one LLGSParams field")
    ladders = [jnp.asarray(vary[n], dtype) for n in names]
    n_points = ladders[0].shape[0]
    for n, lad in zip(names, ladders):
        if lad.shape[0] != n_points:
            raise ValueError(f"ladder {n!r} length {lad.shape[0]} != {n_points}")
    B = n_points * n_ensemble

    fields = {n: jnp.repeat(lad, n_ensemble) for n, lad in zip(names, ladders)}
    params = base_params.astype(dtype).replace(**fields)

    from ..physics.integrator import max_substeps_for

    config = IntegratorConfig(
        method=method,
        max_substeps=max_substeps_for(float(duration)),
        thermal=temperature > 0.0,
        noise_mode=noise_mode,
        rk4_noise="per_substep",
    )
    m0, _ = _tilted_m0(B, dtype, sign=-1.0)
    spans = jnp.full((B,), duration, dtype)
    cur = jnp.full((B,), current, dtype)

    @jax.jit
    def run(m0, spans, cur, key):
        res = integrate_pulse(
            m0, span=spans, current=cur, params=params, config=config,
            key=key, temperature=jnp.asarray(temperature, dtype),
            mesh=mesh, data_axis=data_axis,
        )
        mz = res.m[2]
        switched = (mz > 0) & ~res.failed
        return _ensemble_stats(switched, res.failed, n_points)

    *m0, spans, cur = _maybe_shard(mesh, data_axis, *m0, spans, cur)
    p, failed_frac = run(tuple(m0), spans, cur, key)
    out = {"p_switch": p, "failed_fraction": failed_frac}
    out.update({n: lad for n, lad in zip(names, ladders)})
    return out
