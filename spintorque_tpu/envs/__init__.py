"""RL environments: vectorized functional cores + Gymnasium adapters.

Counterpart of spin_torque_gym/envs (__init__.py:14-33).
"""

from .array import (
    ArrayEnvConfig,
    ArrayEnvState,
    ArrayTimeStep,
    SpinTorqueArrayEnv,
    checkerboard_pattern,
    coupling_matrix,
)
from .skyrmion import (
    SkyrmionEnvConfig,
    SkyrmionEnvState,
    SkyrmionRacetrackEnv,
    SkyrmionTimeStep,
)
from .spin_torque import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig, TimeStep

try:
    from .wrappers import EpisodeStatisticsWrapper, RobustEnvironmentWrapper
    from .gym_adapter import (
        GymSkyrmionRacetrackEnv,
        GymSpinTorqueArrayEnv,
        GymSpinTorqueEnv,
        VectorSpinTorqueEnv,
    )
except ImportError:  # gymnasium unavailable
    GymSpinTorqueEnv = None
    GymSpinTorqueArrayEnv = None
    GymSkyrmionRacetrackEnv = None
    VectorSpinTorqueEnv = None
    RobustEnvironmentWrapper = None
    EpisodeStatisticsWrapper = None

__all__ = [
    "EnvState",
    "SpinTorqueEnv",
    "SpinTorqueEnvConfig",
    "TimeStep",
    "ArrayEnvConfig",
    "ArrayEnvState",
    "ArrayTimeStep",
    "SpinTorqueArrayEnv",
    "checkerboard_pattern",
    "coupling_matrix",
    "SkyrmionEnvConfig",
    "SkyrmionEnvState",
    "SkyrmionRacetrackEnv",
    "SkyrmionTimeStep",
    "GymSpinTorqueEnv",
    "GymSpinTorqueArrayEnv",
    "GymSkyrmionRacetrackEnv",
    "VectorSpinTorqueEnv",
    "RobustEnvironmentWrapper",
    "EpisodeStatisticsWrapper",
]
