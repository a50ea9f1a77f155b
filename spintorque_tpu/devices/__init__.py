"""Device models: parameter pytrees + pure per-type physics functions.

Counterpart of the reference device layer
(spin_torque_gym/devices/__init__.py:10-41).
"""

from .factory import Device, DeviceFactory, create_device, device_factory
from .params import (
    DEVICE_TYPES,
    DeviceParams,
    default_device_dict,
    make_device_params,
    validate_device_dict,
)
from .skyrmion_ops import (
    exchange_length,
    magnus_coefficient,
    skyrmion_energy,
    skyrmion_hall_angle,
    skyrmion_resistance,
    skyrmion_stability,
    skyrmion_velocity,
)
from .resistance import (
    energy_barrier,
    pulse_energy,
    resistance,
    sot_spin_torques,
    sot_switching_threshold,
    sot_switching_time,
    sot_torque_factors,
    vcma_effective_anisotropy,
    vcma_leakage_current,
    vcma_pulse_energy,
    vcma_switching_probability,
    vcma_switching_time,
)

__all__ = [
    "Device",
    "DeviceFactory",
    "create_device",
    "device_factory",
    "DEVICE_TYPES",
    "DeviceParams",
    "default_device_dict",
    "make_device_params",
    "validate_device_dict",
    "energy_barrier",
    "pulse_energy",
    "resistance",
    "sot_spin_torques",
    "sot_switching_threshold",
    "sot_switching_time",
    "sot_torque_factors",
    "vcma_effective_anisotropy",
    "vcma_leakage_current",
    "vcma_pulse_energy",
    "vcma_switching_probability",
    "vcma_switching_time",
    "exchange_length",
    "magnus_coefficient",
    "skyrmion_energy",
    "skyrmion_hall_angle",
    "skyrmion_resistance",
    "skyrmion_stability",
    "skyrmion_velocity",
]
