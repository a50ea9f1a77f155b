"""Material property database for spintronic simulations.

Data-level port of the reference database (spin_torque_gym/physics/
materials.py:46-169 - material constants are data, not code) with the same
capabilities: temperature-adjusted properties, bilayer averaging, JSON
import/export, and per-device-type recommendations (:197-421). Arrays of
temperatures are supported (vectorized with numpy; these run host-side at
setup time, not in the device hot loop).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass
class MaterialProperties:
    """Physical properties of a magnetic / heavy-metal material."""

    name: str
    saturation_magnetization: float  # A/m
    exchange_constant: float  # J/m
    gilbert_damping: float
    uniaxial_anisotropy: float  # J/m^3
    g_factor: float
    curie_temperature: float  # K
    density: float  # kg/m^3
    resistivity: float  # Ohm*m
    spin_polarization: float
    ms_temperature_coeff: float = 0.0  # 1/K
    damping_temperature_coeff: float = 0.0  # 1/K
    anisotropy_temperature_coeff: float = 0.0  # J/m^3/K


_DEFAULT_MATERIALS: Dict[str, MaterialProperties] = {
    "CoFeB": MaterialProperties(
        name="CoFeB", saturation_magnetization=800e3, exchange_constant=20e-12,
        gilbert_damping=0.01, uniaxial_anisotropy=1.0e6, g_factor=2.1,
        curie_temperature=650, density=7800, resistivity=150e-8,
        spin_polarization=0.7, ms_temperature_coeff=-2e-3,
        damping_temperature_coeff=1e-5, anisotropy_temperature_coeff=-3e3,
    ),
    "Fe": MaterialProperties(
        name="Fe", saturation_magnetization=1.7e6, exchange_constant=21e-12,
        gilbert_damping=0.002, uniaxial_anisotropy=0.5e6, g_factor=2.09,
        curie_temperature=1043, density=7870, resistivity=10e-8,
        spin_polarization=0.44, ms_temperature_coeff=-1.5e-3,
        damping_temperature_coeff=5e-6, anisotropy_temperature_coeff=-1e3,
    ),
    "Co": MaterialProperties(
        name="Co", saturation_magnetization=1.4e6, exchange_constant=30e-12,
        gilbert_damping=0.005, uniaxial_anisotropy=4.5e5, g_factor=2.18,
        curie_temperature=1388, density=8900, resistivity=6e-8,
        spin_polarization=0.34, ms_temperature_coeff=-1.2e-3,
        damping_temperature_coeff=8e-6, anisotropy_temperature_coeff=-2e3,
    ),
    "Ni": MaterialProperties(
        name="Ni", saturation_magnetization=485e3, exchange_constant=9e-12,
        gilbert_damping=0.045, uniaxial_anisotropy=-0.5e5, g_factor=2.18,
        curie_temperature=627, density=8900, resistivity=7e-8,
        spin_polarization=0.11, ms_temperature_coeff=-2.5e-3,
        damping_temperature_coeff=2e-5, anisotropy_temperature_coeff=-1e2,
    ),
    "Pt": MaterialProperties(
        name="Pt", saturation_magnetization=0, exchange_constant=0,
        gilbert_damping=0, uniaxial_anisotropy=0, g_factor=0,
        curie_temperature=0, density=21450, resistivity=10.6e-8,
        spin_polarization=0,
    ),
    "Ta": MaterialProperties(
        name="Ta", saturation_magnetization=0, exchange_constant=0,
        gilbert_damping=0, uniaxial_anisotropy=0, g_factor=0,
        curie_temperature=0, density=16650, resistivity=12.4e-8,
        spin_polarization=0,
    ),
    "W": MaterialProperties(
        name="W", saturation_magnetization=0, exchange_constant=0,
        gilbert_damping=0, uniaxial_anisotropy=0, g_factor=0,
        curie_temperature=0, density=19300, resistivity=5.6e-8,
        spin_polarization=0,
    ),
}

_RECOMMENDATIONS = {
    # materials.py:373-421 - per-device-type material suggestions.
    "stt_mram": {"free_layer": "CoFeB", "reference_layer": "CoFeB"},
    "sot_mram": {"free_layer": "CoFeB", "heavy_metal": "Pt"},
    "vcma_mram": {"free_layer": "CoFeB", "dielectric": "MgO"},
    "skyrmion": {"ferromagnet": "Co", "heavy_metal": "Pt"},
}


class MaterialDatabase:
    """Lookup and manipulation of material property sets."""

    def __init__(self, custom_materials: Optional[Dict[str, MaterialProperties]] = None):
        self._materials = dict(_DEFAULT_MATERIALS)
        if custom_materials:
            self._materials.update(custom_materials)

    def get_material(self, name: str) -> MaterialProperties:
        if name not in self._materials:
            raise KeyError(
                f"Unknown material '{name}'. Available: {sorted(self._materials)}"
            )
        return self._materials[name]

    def list_materials(self) -> List[str]:
        return sorted(self._materials)

    def add_material(self, material: MaterialProperties) -> None:
        self._materials[material.name] = material

    def get_temperature_adjusted(self, name: str, temperature: float) -> MaterialProperties:
        """Linear temperature adjustment around 300 K (materials.py:197-237);
        Ms and K_u clamp at zero above the effective Curie point."""
        base = self.get_material(name)
        dT = np.asarray(temperature) - 300.0
        ms = base.saturation_magnetization * (1.0 + base.ms_temperature_coeff * dT)
        alpha = base.gilbert_damping * (1.0 + base.damping_temperature_coeff * dT)
        ku = base.uniaxial_anisotropy + base.anisotropy_temperature_coeff * dT
        ms = float(np.maximum(ms, 0.0)) if np.ndim(ms) == 0 else np.maximum(ms, 0.0)
        return MaterialProperties(
            name=base.name,
            saturation_magnetization=ms,
            exchange_constant=base.exchange_constant,
            gilbert_damping=float(np.abs(alpha)) if np.ndim(alpha) == 0 else np.abs(alpha),
            uniaxial_anisotropy=ku if np.ndim(ku) else float(ku),
            g_factor=base.g_factor,
            curie_temperature=base.curie_temperature,
            density=base.density,
            resistivity=base.resistivity,
            spin_polarization=base.spin_polarization,
            ms_temperature_coeff=base.ms_temperature_coeff,
            damping_temperature_coeff=base.damping_temperature_coeff,
            anisotropy_temperature_coeff=base.anisotropy_temperature_coeff,
        )

    def create_bilayer(
        self, name_a: str, name_b: str, thickness_a: float, thickness_b: float
    ) -> MaterialProperties:
        """Thickness-weighted bilayer averaging (materials.py:239-297)."""
        a, b = self.get_material(name_a), self.get_material(name_b)
        t = thickness_a + thickness_b
        wa, wb = thickness_a / t, thickness_b / t

        def avg(x, y):
            return wa * x + wb * y

        return MaterialProperties(
            name=f"{name_a}/{name_b}",
            saturation_magnetization=avg(a.saturation_magnetization, b.saturation_magnetization),
            exchange_constant=avg(a.exchange_constant, b.exchange_constant),
            gilbert_damping=avg(a.gilbert_damping, b.gilbert_damping),
            uniaxial_anisotropy=avg(a.uniaxial_anisotropy, b.uniaxial_anisotropy),
            g_factor=avg(a.g_factor, b.g_factor),
            curie_temperature=min(x for x in (a.curie_temperature, b.curie_temperature) if x > 0)
            if (a.curie_temperature > 0 or b.curie_temperature > 0)
            else 0.0,
            density=avg(a.density, b.density),
            resistivity=avg(a.resistivity, b.resistivity),
            spin_polarization=avg(a.spin_polarization, b.spin_polarization),
            ms_temperature_coeff=avg(a.ms_temperature_coeff, b.ms_temperature_coeff),
            damping_temperature_coeff=avg(a.damping_temperature_coeff, b.damping_temperature_coeff),
            anisotropy_temperature_coeff=avg(
                a.anisotropy_temperature_coeff, b.anisotropy_temperature_coeff
            ),
        )

    def recommend_materials(self, device_type: str) -> Dict[str, str]:
        return dict(_RECOMMENDATIONS.get(device_type.lower(), {}))

    def export_json(self, path: str | Path) -> None:
        payload = {name: asdict(mat) for name, mat in self._materials.items()}
        Path(path).write_text(json.dumps(payload, indent=2))

    def import_json(self, path: str | Path) -> None:
        payload = json.loads(Path(path).read_text())
        for name, props in payload.items():
            self._materials[name] = MaterialProperties(**props)
