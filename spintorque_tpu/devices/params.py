"""Device parameter structs and canonical defaults.

The reference models devices as Python classes holding a dict of scalars
(spin_torque_gym/devices/base_device.py:13-33). Here a "device" is a
struct-of-arrays parameter pytree living in HBM: every field is a scalar
(shared across the env batch) or a (B,) array (per-env heterogeneous device
sweeps at no extra cost). The canonical default parameter sets reproduce the
reference factory's (device_factory.py:118-194).
"""

from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np
from .. import struct

from ..constants import EPSILON0
from ..physics.llgs import LLGSParams

DEVICE_TYPES = ("stt_mram", "sot_mram", "vcma_mram", "skyrmion", "skyrmion_track")


@struct.dataclass
class DeviceParams:
    """Unified spintronic device parameter pytree.

    Superset of the per-type parameter dicts in the reference factory;
    fields irrelevant to a device type hold that type's reference defaults.
    All fields broadcast scalar-or-(B,) except the axis vectors ((3,) or
    (B, 3)).
    """

    # Geometry
    volume: Any
    area: Any
    thickness: Any
    aspect_ratio: Any
    # Magnetics
    saturation_magnetization: Any
    damping: Any
    uniaxial_anisotropy: Any
    exchange_constant: Any
    polarization: Any
    easy_axis: Any  # (3,) or (B, 3)
    reference_magnetization: Any  # (3,) or (B, 3)
    # Electrical
    resistance_parallel: Any
    resistance_antiparallel: Any
    # SOT (sot_mram.py:36-41)
    spin_hall_angle: Any
    heavy_metal_thickness: Any
    heavy_metal_resistivity: Any
    interface_transparency: Any
    field_like_efficiency: Any
    damping_like_efficiency: Any
    # VCMA (vcma_mram.py:35-43)
    vcma_coefficient: Any
    dielectric_thickness: Any
    dielectric_constant: Any
    breakdown_voltage: Any
    leakage_resistance: Any
    # Skyrmion (skyrmion_device.py:36-47)
    dmi_constant: Any
    skyrmion_radius: Any
    track_width: Any
    pinning_strength: Any

    def llgs(self) -> LLGSParams:
        """The parameter subset consumed by the LLGS hot loop."""
        return LLGSParams(
            saturation_magnetization=self.saturation_magnetization,
            damping=self.damping,
            uniaxial_anisotropy=self.uniaxial_anisotropy,
            volume=self.volume,
            polarization=self.polarization,
            easy_axis=self.easy_axis,
        )

    def astype(self, dtype) -> "DeviceParams":
        import jax

        return jax.tree.map(lambda x: jnp.asarray(x, dtype), self)

    # --- derived SOT quantities (sot_mram.py:61-76) ---
    def sot_js_efficiency(self):
        return (
            self.spin_hall_angle
            * self.interface_transparency
            * (self.heavy_metal_thickness / (self.heavy_metal_thickness + self.thickness))
        )

    def sot_tau_dl_factor(self):
        return self.damping_like_efficiency * self.sot_js_efficiency()

    def sot_tau_fl_factor(self):
        return self.field_like_efficiency * self.sot_js_efficiency()

    def sot_sheet_resistance(self):
        return self.heavy_metal_resistivity / self.heavy_metal_thickness

    # --- derived VCMA quantities (vcma_mram.py:62-86) ---
    def vcma_capacitance(self):
        return EPSILON0 * self.dielectric_constant * self.area / self.dielectric_thickness


# Canonical defaults (device_factory.py:118-194). Plain dicts so they can be
# merged with user overrides before array conversion.
_STT_DEFAULTS: Dict[str, Any] = dict(
    volume=50e-9 * 100e-9 * 2e-9,
    area=50e-9 * 100e-9,
    thickness=2e-9,
    aspect_ratio=2.0,
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    exchange_constant=20e-12,
    polarization=0.7,
    resistance_parallel=1e3,
    resistance_antiparallel=2e3,
    easy_axis=np.array([0.0, 0.0, 1.0]),
    reference_magnetization=np.array([0.0, 0.0, 1.0]),
)

_SOT_DEFAULTS: Dict[str, Any] = dict(
    volume=100e-9 * 100e-9 * 1e-9,
    area=100e-9 * 100e-9,
    thickness=1e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.015,
    uniaxial_anisotropy=0.8e6,
    exchange_constant=20e-12,
    spin_hall_angle=0.2,
    resistance_parallel=500.0,
    resistance_antiparallel=1000.0,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

_VCMA_DEFAULTS: Dict[str, Any] = dict(
    volume=80e-9 * 80e-9 * 1.5e-9,
    area=80e-9 * 80e-9,
    thickness=1.5e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.008,
    uniaxial_anisotropy=1.5e6,
    exchange_constant=20e-12,
    vcma_coefficient=100e-6,
    resistance_parallel=2e3,
    resistance_antiparallel=4e3,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

_SKYRMION_DEFAULTS: Dict[str, Any] = dict(
    volume=200e-9 * 50e-9 * 0.5e-9,
    area=200e-9 * 50e-9,
    thickness=0.5e-9,
    aspect_ratio=1.0,
    saturation_magnetization=600e3,
    damping=0.02,
    dmi_constant=3e-3,
    exchange_constant=15e-12,
    skyrmion_radius=10e-9,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

# Fields every DeviceParams instance carries, with cross-type fallbacks
# matching the attribute defaults baked into the reference device classes
# (sot_mram.py:36-41, vcma_mram.py:36-43, skyrmion_device.py:36-47,
# base_device.py:25-28, simple_solver.py:310-315).
_GLOBAL_FALLBACKS: Dict[str, Any] = dict(
    volume=1e-24,
    area=1e-14,
    thickness=1e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1e6,
    exchange_constant=20e-12,
    polarization=0.7,
    easy_axis=np.array([0.0, 0.0, 1.0]),
    reference_magnetization=np.array([0.0, 0.0, 1.0]),
    resistance_parallel=1e3,
    resistance_antiparallel=2e3,
    spin_hall_angle=0.1,
    heavy_metal_thickness=5e-9,
    heavy_metal_resistivity=2e-7,
    interface_transparency=0.5,
    field_like_efficiency=0.1,
    damping_like_efficiency=0.2,
    vcma_coefficient=100e-6,
    dielectric_thickness=1e-9,
    dielectric_constant=25.0,
    breakdown_voltage=2.0,
    leakage_resistance=1e12,
    dmi_constant=3e-3,
    skyrmion_radius=20e-9,
    track_width=200e-9,
    pinning_strength=0.1,
)

_TYPE_DEFAULTS = {
    "stt_mram": _STT_DEFAULTS,
    "sot_mram": _SOT_DEFAULTS,
    "vcma_mram": _VCMA_DEFAULTS,
    "skyrmion": _SKYRMION_DEFAULTS,
    "skyrmion_track": _SKYRMION_DEFAULTS,
}


def default_device_dict(device_type: str) -> Dict[str, Any]:
    """Full parameter dict for a device type (reference factory defaults
    merged over global fallbacks)."""
    device_type = device_type.lower()
    if device_type not in _TYPE_DEFAULTS:
        raise ValueError(
            f"Unknown device type '{device_type}'. Available: {list(_TYPE_DEFAULTS)}"
        )
    merged = dict(_GLOBAL_FALLBACKS)
    merged.update(_TYPE_DEFAULTS[device_type])
    return merged


def validate_device_dict(device_type: str, params: Dict[str, Any]) -> None:
    """Range validation mirroring the reference device classes
    (stt_mram.py:32-54; the reference's SOT/VCMA/skyrmion validators are
    stubs, but we validate the shared ranges for all types)."""
    if params["volume"] <= 0:
        raise ValueError("Volume must be positive")
    if params["saturation_magnetization"] <= 0:
        raise ValueError("Saturation magnetization must be positive")
    if not 0 <= params["damping"] <= 1:
        raise ValueError("Damping must be between 0 and 1")
    if device_type == "stt_mram" and not 0 <= params["polarization"] <= 1:
        raise ValueError("Polarization must be between 0 and 1")


def make_device_params(
    device_type: str,
    overrides: Dict[str, Any] | None = None,
    dtype=jnp.float32,
    validate: bool = True,
) -> DeviceParams:
    """Build a DeviceParams pytree for ``device_type`` with optional
    overrides (the on-device analog of DeviceFactory.create_device,
    device_factory.py:49-77)."""
    merged = default_device_dict(device_type)
    if overrides:
        unknown = set(overrides) - set(merged)
        # Tolerate extra keys the way the reference dict-based devices do,
        # but only silently drop ones we know are informational.
        merged.update({k: v for k, v in overrides.items() if k in merged})
        if unknown and validate:
            allowed_extra = {"temperature", "length", "width", "resistivity",
                             "anisotropy_constant", "base_resistance",
                             "skyrmion_resistance_factor", "capacitance_per_area",
                             "perpendicular_anisotropy", "heavy_metal_layer",
                             "ferromagnet_layer"}
            bad = unknown - allowed_extra
            if bad:
                raise ValueError(f"Unknown device parameters: {sorted(bad)}")
    if validate:
        validate_device_dict(device_type, merged)

    def conv(v):
        return jnp.asarray(np.asarray(v), dtype)

    return DeviceParams(**{k: conv(v) for k, v in merged.items()})
