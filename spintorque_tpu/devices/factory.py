"""Device factory: registry + construction of device parameter pytrees.

Counterpart of the reference DeviceFactory (spin_torque_gym/devices/
device_factory.py:18-265). Instead of instantiating per-device Python
objects, creation yields a ``Device`` facade binding a static device type to
a DeviceParams pytree plus the pure per-type functions - usable standalone
and directly consumable by the vectorized environments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from . import resistance as rfn
from .params import (
    DEVICE_TYPES,
    DeviceParams,
    default_device_dict,
    make_device_params,
    validate_device_dict,
)


class Device:
    """Facade binding a device type to its parameter pytree.

    API mirrors the reference BaseSpintronicDevice surface
    (base_device.py:44-138) but every method is batched: magnetization
    arguments may be (3,) or (B, 3).
    """

    def __init__(self, device_type: str, params: DeviceParams, raw: Dict[str, Any]):
        self.device_type = device_type
        self.params = params
        self._raw = raw  # the merged parameter dict (host-side scalars)

    # dict-like parameter access (base_device.py:73-92)
    def get_parameter(self, key: str, default: Any = None) -> Any:
        return self._raw.get(key, default)

    def set_parameter(self, key: str, value: Any) -> None:
        self._raw[key] = value
        if key in DeviceParams.__dataclass_fields__:
            self.params = self.params.replace(**{key: jnp.asarray(np.asarray(value))})

    @property
    def device_params(self) -> Dict[str, Any]:
        return self._raw

    def _split(self, m):
        m = jnp.asarray(m)
        return m[..., 0], m[..., 1], m[..., 2]

    def compute_resistance(self, magnetization):
        mx, my, mz = self._split(magnetization)
        return rfn.resistance(self.device_type, mx, my, mz, self.params)

    def compute_effective_field(self, magnetization, applied_field):
        from ..physics.llgs import effective_field

        mx, my, mz = self._split(magnetization)
        ax, ay, az = self._split(applied_field)
        hx, hy, hz = effective_field(
            mx, my, mz, self.params.llgs(), h_applied=(ax, ay, az)
        )
        return jnp.stack([hx, hy, hz], axis=-1)

    def validate_magnetization(self, magnetization):
        m = np.asarray(magnetization, float)
        if m.shape[-1] != 3:
            raise ValueError(f"Magnetization must be 3D vector, got shape {m.shape}")
        norm = np.linalg.norm(m, axis=-1, keepdims=True)
        if np.any(norm < 1e-12):
            raise ValueError("Magnetization vector cannot be zero")
        return m / norm

    def compute_power_consumption(self, current_density, pulse_duration, magnetization):
        r = self.compute_resistance(magnetization)
        return rfn.pulse_energy(current_density, pulse_duration, r, self.params.area)

    def get_switching_threshold(self) -> Dict[str, Any]:
        if self.device_type == "sot_mram":
            return {
                "critical_current_density": float(rfn.sot_switching_threshold(self.params)),
                "damping_like_efficiency": float(self.params.sot_tau_dl_factor()),
                "field_like_efficiency": float(self.params.sot_tau_fl_factor()),
            }
        if self.device_type == "vcma_mram":
            k0 = float(np.asarray(self.params.uniaxial_anisotropy))
            xi = float(np.asarray(self.params.vcma_coefficient))
            t = float(np.asarray(self.params.thickness))
            v_bd = float(np.asarray(self.params.breakdown_voltage))
            v_crit = min(abs(k0 * t / xi), v_bd)  # vcma_mram.py:288-299
            return {"critical_voltage": v_crit, "breakdown_voltage": v_bd,
                    "vcma_coefficient": xi}
        return {}

    def get_device_info(self) -> Dict[str, Any]:
        return {
            "device_type": self.device_type,
            "volume": float(np.asarray(self.params.volume)),
            "thickness": float(np.asarray(self.params.thickness)),
            "saturation_magnetization": float(
                np.asarray(self.params.saturation_magnetization)
            ),
            "parameters": dict(self._raw),
        }

    def __repr__(self) -> str:
        return (
            f"Device({self.device_type}, volume={float(np.asarray(self.params.volume)):.2e}, "
            f"Ms={float(np.asarray(self.params.saturation_magnetization)):.0f})"
        )


class DeviceFactory:
    """Registry of device types (device_factory.py:18-116)."""

    def __init__(self):
        self._builders: Dict[str, Callable[..., Device]] = {}
        for t in DEVICE_TYPES:
            self.register_device(t, self._default_builder(t))

    def _default_builder(self, device_type: str):
        def build(device_params: Optional[Dict[str, Any]] = None, dtype=jnp.float32):
            merged = default_device_dict(device_type)
            if device_params:
                merged.update(device_params)
            validate_device_dict(device_type, merged)
            params = make_device_params(device_type, device_params, dtype=dtype,
                                        validate=False)
            return Device(device_type, params, merged)

        return build

    def register_device(self, device_type: str, builder: Callable[..., Device]) -> None:
        self._builders[device_type.lower()] = builder

    def create_device(
        self, device_type: str, device_params: Optional[Dict[str, Any]] = None,
        dtype=jnp.float32,
    ) -> Device:
        device_type = device_type.lower()
        if device_type not in self._builders:
            raise ValueError(
                f"Unknown device type '{device_type}'. Available types: "
                f"{sorted(self._builders)}"
            )
        return self._builders[device_type](device_params, dtype=dtype)

    def create_default_device(self, device_type: str) -> Device:
        return self.create_device(device_type, None)

    def get_default_parameters(self, device_type: str) -> Dict[str, Any]:
        return default_device_dict(device_type)

    def get_available_devices(self) -> List[str]:
        return sorted(self._builders)

    def get_device_info(self, device_type: str) -> Dict[str, Any]:
        device_type = device_type.lower()
        if device_type not in self._builders:
            raise ValueError(f"Unknown device type '{device_type}'")
        return {"name": device_type, "class": "Device", "module": __name__}


# Module-level factory + helper (devices/__init__.py:18-30, device_factory.py:265)
device_factory = DeviceFactory()


def create_device(device_type: str, device_params: Optional[Dict[str, Any]] = None,
                  **kwargs) -> Device:
    if device_params is None and kwargs:
        device_params = kwargs
    return device_factory.create_device(device_type, device_params)
