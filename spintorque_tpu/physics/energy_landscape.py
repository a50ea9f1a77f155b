"""Single-domain magnetic energy landscape analysis.

Counterpart of spin_torque_gym/physics/energy_landscape.py (:14-357).
The reference finds stable states with per-point SciPy BFGS loops and scans
phase diagrams point by point; here every analysis is a single vmapped/jitted
evaluation over (theta, phi) grids - the whole landscape in one device pass.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import KB, MU0
from .llgs import LLGSParams


def _spherical_to_cart(theta, phi):
    st = jnp.sin(theta)
    return st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)


class EnergyLandscape:
    """Energy landscape utilities for a uniaxial single-domain particle.

    E(m) = -mu0 Ms V (m . H) - K_u V (m . e)^2 + (1/2) mu0 Ms^2 V N m_z^2
    (energy_landscape.py:36-71; thin-film demag factor N=1 along z).
    """

    def __init__(self, params: LLGSParams, include_demag: bool = True):
        self.params = params.astype(jnp.float64) if hasattr(params, "astype") else params
        self.include_demag = include_demag

    def energy(self, m, applied_field=(0.0, 0.0, 0.0)):
        """Total energy (J) for magnetization direction(s) m (..., 3)."""
        p = self.params
        m = jnp.asarray(m)
        mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
        e = jnp.asarray(p.easy_axis)
        e = e / jnp.linalg.norm(e)
        h = jnp.asarray(applied_field)
        vol = p.volume
        ms = p.saturation_magnetization
        zeeman = -MU0 * ms * vol * (
            mx * h[..., 0] + my * h[..., 1] + mz * h[..., 2]
        )
        m_dot_e = mx * e[0] + my * e[1] + mz * e[2]
        anis = -p.uniaxial_anisotropy * vol * m_dot_e**2
        demag = 0.5 * MU0 * ms**2 * vol * mz**2 if self.include_demag else 0.0
        return zeeman + anis + demag

    def energy_surface(
        self,
        n_theta: int = 90,
        n_phi: int = 180,
        applied_field=(0.0, 0.0, 0.0),
    ) -> Dict[str, jnp.ndarray]:
        """Full (theta, phi) energy surface in one vmapped evaluation
        (replaces the reference's plotting loop, energy_landscape.py:223-280)."""
        theta = jnp.linspace(0.0, jnp.pi, n_theta)
        phi = jnp.linspace(0.0, 2 * jnp.pi, n_phi)
        tt, pp = jnp.meshgrid(theta, phi, indexing="ij")
        mx, my, mz = _spherical_to_cart(tt, pp)
        m = jnp.stack([mx, my, mz], axis=-1)
        return {
            "theta": theta,
            "phi": phi,
            "energy": self.energy(m, applied_field),
        }

    def effective_field(self, m, applied_field=(0.0, 0.0, 0.0)):
        """H_eff = -dE/dm / (mu0 Ms V) via autodiff
        (energy_landscape.py:73-104 computes this by hand)."""
        p = self.params
        grad = jax.grad(lambda mm: jnp.sum(self.energy(mm, applied_field)))(
            jnp.asarray(m, jnp.float64)
        )
        return -grad / (MU0 * p.saturation_magnetization * p.volume)

    def find_stable_states(
        self,
        n_theta: int = 181,
        n_phi: int = 360,
        applied_field=(0.0, 0.0, 0.0),
        energy_tol: float = 1e-25,
    ) -> np.ndarray:
        """Grid-based local-minimum search (replaces per-seed BFGS loops,
        energy_landscape.py:106-177): evaluate the full surface, return
        directions that are lower than all 8 neighbors."""
        surf = self.energy_surface(n_theta, n_phi, applied_field)
        E = np.asarray(surf["energy"])
        theta, phi = np.asarray(surf["theta"]), np.asarray(surf["phi"])
        # wrap phi for neighbor comparison
        Ew = np.concatenate([E[:, -1:], E, E[:, :1]], axis=1)
        mins = []
        for i in range(1, E.shape[0] - 1):
            for j in range(E.shape[1]):
                window = Ew[i - 1 : i + 2, j : j + 3]
                if E[i, j] <= window.min() + 0.0:
                    mins.append((theta[i], phi[j], E[i, j]))
        # poles
        if E[0].min() <= E[1].min():
            mins.append((0.0, 0.0, float(E[0].min())))
        if E[-1].min() <= E[-2].min():
            mins.append((np.pi, 0.0, float(E[-1].min())))
        # dedupe nearly-degenerate states
        states = []
        for t, p_, e in mins:
            m = np.array(
                [np.sin(t) * np.cos(p_), np.sin(t) * np.sin(p_), np.cos(t)]
            )
            if not any(np.dot(m, s) > 0.999 for s, _ in states):
                states.append((m, e))
        states.sort(key=lambda x: x[1])
        return np.array([s for s, _ in states])

    def energy_barrier(
        self, m_from, m_to, n_points: int = 100, applied_field=(0.0, 0.0, 0.0)
    ) -> float:
        """Barrier along the normalized linear interpolation path
        (energy_landscape.py:179-221)."""
        m_from = jnp.asarray(m_from, jnp.float64)
        m_to = jnp.asarray(m_to, jnp.float64)
        t = jnp.linspace(0.0, 1.0, n_points)[:, None]
        path = (1 - t) * m_from[None, :] + t * m_to[None, :]
        path = path / jnp.linalg.norm(path, axis=-1, keepdims=True)
        E = self.energy(path, applied_field)
        return float(jnp.max(E) - E[0])

    def thermal_stability_factor(self, temperature: float = 300.0) -> float:
        """Delta = K_u V / k_B T (energy_landscape.py:342-357)."""
        p = self.params
        return float(
            p.uniaxial_anisotropy * p.volume / (KB * temperature)
        )

    def switching_phase_diagram(
        self,
        field_range: Tuple[float, float],
        n_fields: int = 50,
        n_angles: int = 50,
    ) -> Dict[str, jnp.ndarray]:
        """Stoner-Wohlfarth-style astroid: for each (H, angle) does the
        energy surface retain two minima? One vmapped evaluation over the
        whole grid (replaces energy_landscape.py:282-340)."""
        p = self.params
        h_k = 2 * p.uniaxial_anisotropy / (MU0 * p.saturation_magnetization)
        fields = jnp.linspace(field_range[0], field_range[1], n_fields)
        angles = jnp.linspace(0.0, jnp.pi / 2, n_angles)

        theta_grid = jnp.linspace(0.0, jnp.pi, 181)

        def bistable(h_mag, ang):
            hx = h_mag * jnp.sin(ang)
            hz = h_mag * jnp.cos(ang)
            # in-plane (x,z) energy per unit: -h.m - 0.5 h_k (m.e)^2 form
            mx, mz = jnp.sin(theta_grid), jnp.cos(theta_grid)
            e = -(hx * mx + hz * mz) - 0.5 * h_k * mz**2
            interior = (e[1:-1] < e[:-2]) & (e[1:-1] < e[2:])
            n_minima = interior.sum() + (e[0] < e[1]) + (e[-1] < e[-2])
            return n_minima >= 2

        grid = jax.vmap(lambda h: jax.vmap(lambda a: bistable(h, a))(angles))(fields)
        return {"fields": fields, "angles": angles, "bistable": grid,
                "anisotropy_field": h_k}
