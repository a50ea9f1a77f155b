"""spintorque_tpu: accelerator-native spintronic-device RL environment engine.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
danieleschmidt/spin-torque-rl-gym: batched Landau-Lifshitz-Gilbert-Slonczewski
physics, STT/SOT/VCMA/skyrmion device models, vectorized Gymnasium-compatible
RL environments, composite rewards, and pod-scale sharded rollout - with the
entire env.step hot path compiled into a single fused device program.

Importing the package registers the Gymnasium environment ids
(SpinTorque-v0, SpinTorqueArray-v0, SkyrmionRacetrack-v0), mirroring the
reference (spin_torque_gym/__init__.py:14-32).
"""

__version__ = "0.5.0"

from . import constants, devices, physics, rewards
from .devices import DeviceFactory, DeviceParams, create_device
from .envs import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig, TimeStep
from .physics import (
    IntegratorConfig,
    LLGSParams,
    LLGSSolver,
    MaterialDatabase,
    SimpleLLGSSolver,
    ThermalFluctuations,
)
from .rewards import CompositeReward

# Gymnasium registration is optional (gymnasium is an interop dependency, not
# a core one); the functional API works without it.
try:  # pragma: no cover - exercised via gym adapters
    from .registration import register_envs

    register_envs()
except ImportError:  # gymnasium not installed or adapters not yet built
    pass

__all__ = [
    "constants",
    "devices",
    "physics",
    "rewards",
    "DeviceFactory",
    "DeviceParams",
    "create_device",
    "EnvState",
    "SpinTorqueEnv",
    "SpinTorqueEnvConfig",
    "TimeStep",
    "IntegratorConfig",
    "LLGSParams",
    "LLGSSolver",
    "SimpleLLGSSolver",
    "MaterialDatabase",
    "ThermalFluctuations",
    "CompositeReward",
    "__version__",
]
