"""Skyrmion device-level physics functions.

Counterpart of the reference SkyrmionDevice methods
(spin_torque_gym/devices/skyrmion_device.py:16-477): Thiele-equation
velocity, Hall angle, exchange length, skyrmion energy, stability factor
and count-dependent resistance - as pure batched jnp functions. The
racetrack *environment* dynamics (skyrmion_env semantics) live in
envs/skyrmion.py; these are the standalone device-physics queries.
"""

from __future__ import annotations

import math
import jax.numpy as jnp

from ..constants import KB_SOLVER, MU0
from .params import DeviceParams


def exchange_length(params: DeviceParams):
    """l_ex = sqrt(2A/K) with anisotropy, else sqrt(2A/(mu0 Ms^2))
    (skyrmion_device.py:92-106)."""
    a = params.exchange_constant
    k = params.uniaxial_anisotropy
    ms = params.saturation_magnetization
    with_k = jnp.sqrt(2.0 * a / jnp.maximum(k, 1e-30))
    without_k = jnp.sqrt(2.0 * a / (MU0 * ms**2))
    return jnp.where(k > 0, with_k, without_k)


def magnus_coefficient(params: DeviceParams):
    """G = 4 pi Ms t (skyrmion_device.py:85-87)."""
    return 4.0 * math.pi * params.saturation_magnetization * params.thickness


def skyrmion_hall_angle(params: DeviceParams):
    """Empirical arctan(alpha/0.1), clipped 5-45 deg
    (skyrmion_device.py:217-229)."""
    angle = jnp.arctan(params.damping / 0.1)
    return jnp.clip(angle, math.radians(5.0), math.radians(45.0))


def skyrmion_velocity(
    params: DeviceParams,
    current_density,  # (..., 2) [Jx, Jy]
    external_force=(0.0, 0.0),
) -> jnp.ndarray:
    """Thiele-like velocity v = F_total / (alpha G)
    (skyrmion_device.py:165-215). Batched over leading dims."""
    j = jnp.asarray(current_density)
    j_mag = jnp.linalg.norm(j, axis=-1, keepdims=True)
    safe = jnp.maximum(j_mag, 1e-30)
    j_dir = j / safe
    mobility = params.spin_hall_angle * params.interface_transparency
    g = magnus_coefficient(params)
    mass_eff = g * params.skyrmion_radius**2
    force_mag = mobility * j_mag * mass_eff
    f_drive = force_mag * j_dir
    perp = jnp.stack([-j_dir[..., 1], j_dir[..., 0]], axis=-1)
    f_magnus = force_mag * jnp.tan(skyrmion_hall_angle(params)) * perp
    f = jnp.where(j_mag > 1e-12, f_drive + f_magnus, 0.0)
    f = f + jnp.asarray(external_force)
    damping_coeff = params.damping * g
    return f / damping_coeff


def skyrmion_energy(params: DeviceParams):
    """E = 8 pi A - 4 pi D r + pi K r^2 t + demag (skyrmion_device.py:293-313)."""
    a = params.exchange_constant
    d = params.dmi_constant
    r = params.skyrmion_radius
    k = params.uniaxial_anisotropy
    t = params.thickness
    ms = params.saturation_magnetization
    e_ex = 8.0 * math.pi * a
    e_dmi = -4.0 * math.pi * d * r
    e_anis = math.pi * k * r**2 * t
    e_demag = MU0 * ms**2 * r**2 * t / 2.0
    return e_ex + e_dmi + e_anis + e_demag


def skyrmion_stability(params: DeviceParams, position_y, temperature=300.0):
    """Stability factor in [0, 1] vs 40 kT, halved near track edges
    (skyrmion_device.py:255-291)."""
    e = jnp.abs(skyrmion_energy(params))
    thermal = KB_SOLVER * temperature
    stability = jnp.minimum(1.0, e / (40.0 * thermal))
    y = jnp.asarray(position_y)
    near_edge = (y < params.skyrmion_radius) | (
        y > params.track_width - params.skyrmion_radius
    )
    return jnp.where(near_edge, stability * 0.5, stability)


def skyrmion_resistance(params: DeviceParams, n_skyrmions,
                        base_resistance: float = 1e3,
                        resistance_factor: float = 0.1):
    """R = R0 (1 + f * n) from topological contributions
    (skyrmion_device.py:315-340)."""
    n = jnp.asarray(n_skyrmions)
    return jnp.maximum(base_resistance * (1.0 + resistance_factor * n), 1.0)
