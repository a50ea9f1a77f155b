"""Batched Landau-Lifshitz-Gilbert-Slonczewski (LLGS) right-hand side.

Accelerator-native design notes
-------------------------------
The reference evaluates the LLGS RHS one scalar 3-vector at a time inside a
Python loop (reference: spin_torque_gym/physics/simple_solver.py:297-388).
Here the state for a whole batch of B independent device instances is kept as
three (B,)-shaped component arrays (structure-of-arrays): one env per
lane, contiguous loads for each component, and XLA fuses the entire RHS into
a single elementwise kernel.

Physics semantics (matching simple_solver.py so that deterministic
fixed-seed trajectories agree with the reference at matched precision):

    H_eff = H_applied + H_anis + H_demag + H_thermal
    H_anis = (2 K_u / (mu0 Ms)) (m . e) e          (simple_solver.py:370-371)
    H_demag = -Ms m_z z_hat                        (simple_solver.py:375)
    tau_STT = (P J / (Ms V)) m x (m x e)           (simple_solver.py:324-334)
    dm/dt = -gamma/(1+alpha^2) [m x H + alpha m x (m x H)] + tau_STT
                                                   (simple_solver.py:336-342)

All functions are pure, dtype-polymorphic, and broadcast device parameters:
each parameter may be a scalar (shared across the batch) or a (B,) array
(heterogeneous device sweeps at zero extra cost).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp
from .. import struct

from ..constants import GAMMA, KB_SOLVER, MU0

Array = Any  # jax.Array; kept loose so numpy inputs also work under jit tracing.


@struct.dataclass
class LLGSParams:
    """Device parameters consumed by the LLGS hot loop.

    Mirrors the parameter subset the reference solver reads from its
    device_params dict (simple_solver.py:310-315). Every field is either a
    scalar or a (B,) array; ``easy_axis`` is (3,) or (B, 3).
    """

    saturation_magnetization: Array  # Ms (A/m)
    damping: Array  # Gilbert damping alpha (dimensionless)
    uniaxial_anisotropy: Array  # K_u (J/m^3)
    volume: Array  # V (m^3)
    polarization: Array  # spin polarization P (dimensionless)
    easy_axis: Array  # unit vector, (3,) or (B, 3)

    def astype(self, dtype) -> "LLGSParams":
        return LLGSParams(
            saturation_magnetization=jnp.asarray(self.saturation_magnetization, dtype),
            damping=jnp.asarray(self.damping, dtype),
            uniaxial_anisotropy=jnp.asarray(self.uniaxial_anisotropy, dtype),
            volume=jnp.asarray(self.volume, dtype),
            polarization=jnp.asarray(self.polarization, dtype),
            easy_axis=jnp.asarray(self.easy_axis, dtype),
        )

    def normalized_easy_axis(self) -> Tuple[Array, Array, Array]:
        """Unit easy axis components (the reference re-normalizes every call;
        the result is identical, so we do it once: simple_solver.py:317-318)."""
        e = jnp.asarray(self.easy_axis)
        ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
        norm = jnp.sqrt(ex * ex + ey * ey + ez * ez)
        return ex / norm, ey / norm, ez / norm


def cross(ax, ay, az, bx, by, bz):
    """Component-wise cross product a x b (matches np.cross term order)."""
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def effective_field(
    mx: Array,
    my: Array,
    mz: Array,
    params: LLGSParams,
    h_applied: Tuple[Array, Array, Array] = (0.0, 0.0, 0.0),
    h_thermal: Tuple[Array, Array, Array] = (0.0, 0.0, 0.0),
) -> Tuple[Array, Array, Array]:
    """Effective field H_eff = H_app + H_anis + H_demag + H_thermal.

    Matches simple_solver.py:346-388 (addition order preserved for bitwise
    parity in float64 harnesses).
    """
    ms = params.saturation_magnetization
    k_u = params.uniaxial_anisotropy
    ex, ey, ez = params.normalized_easy_axis()

    h_k = (2.0 * k_u) / (MU0 * ms)
    m_dot_e = mx * ex + my * ey + mz * ez
    anis = h_k * m_dot_e

    hx = h_applied[0] + anis * ex + h_thermal[0]
    hy = h_applied[1] + anis * ey + h_thermal[1]
    # Thin-film shape anisotropy acts on z only: H_demag = -Ms m_z z_hat.
    hz = h_applied[2] + anis * ez - ms * mz + h_thermal[2]
    return hx, hy, hz


def thermal_field_strength(params: LLGSParams, temperature: Array) -> Array:
    """RMS thermal field amplitude used by the reference solver.

    sigma = sqrt(2 alpha k_B T / (mu0 Ms V gamma))   (simple_solver.py:380-383)

    Note: the reference applies this per *field evaluation* without the
    1/sqrt(dt) factor a physically consistent Brown discretization requires;
    ``integrator.py`` offers both that 'reference' mode and a corrected
    'physical' mode.
    """
    ms = params.saturation_magnetization
    return jnp.sqrt(
        2.0 * params.damping * KB_SOLVER * temperature / (MU0 * ms * params.volume * GAMMA)
    )


def dmdt(
    mx: Array,
    my: Array,
    mz: Array,
    current: Array,
    params: LLGSParams,
    h_applied: Tuple[Array, Array, Array] = (0.0, 0.0, 0.0),
    h_thermal: Tuple[Array, Array, Array] = (0.0, 0.0, 0.0),
) -> Tuple[Array, Array, Array]:
    """LLGS time derivative dm/dt (simple_solver.py:297-344).

    current: charge current density J (A/m^2); scalar or (B,).
    """
    alpha = params.damping
    ms = params.saturation_magnetization
    ex, ey, ez = params.normalized_easy_axis()

    hx, hy, hz = effective_field(mx, my, mz, params, h_applied, h_thermal)

    # Spin-transfer torque: (P J / (Ms V)) m x (m x e), gated on |J| > 1e-12
    # (simple_solver.py:324-334). The gate is an elementwise select here.
    ux, uy, uz = cross(mx, my, mz, ex, ey, ez)  # m x e
    vx, vy, vz = cross(mx, my, mz, ux, uy, uz)  # m x (m x e)
    coeff = params.polarization * current / (ms * params.volume)
    coeff = jnp.where(jnp.abs(current) > 1e-12, coeff, 0.0)

    gamma_eff = GAMMA / (1.0 + alpha**2)

    px, py, pz = cross(mx, my, mz, hx, hy, hz)  # precession m x H
    dx, dy, dz = cross(mx, my, mz, px, py, pz)  # m x (m x H)

    out_x = -gamma_eff * (px + alpha * dx) + coeff * vx
    out_y = -gamma_eff * (py + alpha * dy) + coeff * vy
    out_z = -gamma_eff * (pz + alpha * dz) + coeff * vz
    return out_x, out_y, out_z


def normalize_with_fallback(mx, my, mz, dtype=None):
    """Normalize m, falling back to +z for non-finite / near-zero vectors.

    Vectorized equivalent of the reference's validate_magnetization
    (simple_solver.py:208-229): NaN/Inf or |m| < 1e-12 maps to [0, 0, 1].
    Uses true division (not reciprocal multiply) to match numpy bitwise.
    """
    if dtype is None:
        dtype = jnp.result_type(mx)
    norm = jnp.sqrt(mx * mx + my * my + mz * mz)
    finite = jnp.isfinite(mx) & jnp.isfinite(my) & jnp.isfinite(mz)
    ok = finite & (norm >= 1e-12)
    safe_norm = jnp.where(ok, norm, jnp.asarray(1.0, dtype))
    nx, ny, nz = mx / safe_norm, my / safe_norm, mz / safe_norm
    ok = ok & jnp.isfinite(nx) & jnp.isfinite(ny) & jnp.isfinite(nz)
    zero = jnp.asarray(0.0, dtype)
    one = jnp.asarray(1.0, dtype)
    return (
        jnp.where(ok, nx, zero),
        jnp.where(ok, ny, zero),
        jnp.where(ok, nz, one),
    )


def energy_density(mx, my, mz, params: LLGSParams, h_applied=(0.0, 0.0, 0.0)):
    """Single-domain magnetic energy density (J/m^3): Zeeman + uniaxial + demag.

    Mirrors the analytic form in the reference energy landscape
    (energy_landscape.py:36-71) for the thin-film demag used by the solver.
    """
    ms = params.saturation_magnetization
    k_u = params.uniaxial_anisotropy
    ex, ey, ez = params.normalized_easy_axis()
    m_dot_e = mx * ex + my * ey + mz * ez
    zeeman = -MU0 * ms * (mx * h_applied[0] + my * h_applied[1] + mz * h_applied[2])
    anis = -k_u * m_dot_e * m_dot_e
    demag = 0.5 * MU0 * ms * ms * mz * mz
    return zeeman + anis + demag
