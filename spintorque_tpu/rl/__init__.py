"""Native on-device RL training (replaces the reference's stable-baselines3 shell)."""

from .networks import ActorCritic, continuous_action_transform, sample_continuous
from .ppo import PPOConfig, PPOTrainer, TrainState

__all__ = [
    "ActorCritic",
    "continuous_action_transform",
    "sample_continuous",
    "PPOConfig",
    "PPOTrainer",
    "TrainState",
]
