"""Official Gymnasium API compliance for the sb3-facing adapters.

stable-baselines3 cannot be installed in the build environment (no package
installs / no network egress; tests/integration/test_sb3_interop.py runs
the real library in the CI sb3 job instead). What sb3 consumes is exactly
the Gymnasium env API - spaces, reset/step signatures, dtypes, bounds,
seeding - so this file runs gymnasium's OWN validator
(gymnasium.utils.env_checker.check_env, the same checks sb3's
check_for_correct_spaces / VecEnv wrap path relies on) against every
adapter mode the reference's CLI exercises
(/root/reference/spin_torque_gym/cli.py:89-129,257-277).
"""

import warnings

import pytest
from gymnasium.utils.env_checker import check_env

from spintorque_tpu.envs.gym_adapter import GymSpinTorqueEnv

FAST = dict(
    include_thermal_fluctuations=False,
    max_duration=2e-10,
    max_steps=8,
)


@pytest.mark.parametrize("action_mode", ["continuous", "discrete"])
def test_gym_adapter_passes_official_env_checker(action_mode):
    env = GymSpinTorqueEnv(action_mode=action_mode, **FAST)
    with warnings.catch_warnings():
        # The checker warns about non-default render modes etc.; failures
        # are raised as errors, which is what this test pins.
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


def test_gym_adapter_dict_observation_passes_checker():
    env = GymSpinTorqueEnv(observation_mode="dict", **FAST)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


@pytest.mark.parametrize("observation_mode", ["array", "vector", "dict"])
def test_array_adapter_passes_checker(observation_mode):
    from spintorque_tpu.envs.gym_adapter import GymSpinTorqueArrayEnv

    env = GymSpinTorqueArrayEnv(
        array_size=(2, 2), observation_mode=observation_mode, max_steps=4,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


@pytest.mark.parametrize("observation_mode", ["vector", "dict"])
def test_skyrmion_adapter_passes_checker(observation_mode):
    from spintorque_tpu.envs.gym_adapter import GymSkyrmionRacetrackEnv

    env = GymSkyrmionRacetrackEnv(
        observation_mode=observation_mode, max_steps=4,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


def test_gym_adapter_thermal_passes_checker():
    """Thermal mode changes the reset/step numerics path (PRNG plumbing);
    the API contract must hold there too."""
    env = GymSpinTorqueEnv(
        action_mode="continuous", include_thermal_fluctuations=True,
        max_duration=2e-10, max_steps=8,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


def test_adapter_routes_integrator_knobs_and_warns_on_unknown():
    """accelerator-native integrator knobs must reach the config through the gym
    surface, and unknown kwargs must WARN instead of silently running
    default physics (review finding: coupling_update was swallowed)."""
    import warnings

    from spintorque_tpu.envs.gym_adapter import GymSpinTorqueEnv

    e = GymSpinTorqueEnv(method="euler", noise_mode="physical",
                         rk4_noise="per_stage", max_substeps=64,
                         use_pallas=False)
    try:
        cfg = e.unwrapped._env.config
        assert cfg.method == "euler"
        assert cfg.noise_mode == "physical"
        assert cfg.rk4_noise == "per_stage"
        assert cfg.max_substeps == 64
        assert cfg.use_pallas is False
    finally:
        e.close()

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        e = GymSpinTorqueEnv(not_a_real_knob=1)
        e.close()
    assert any("not_a_real_knob" in str(x.message) for x in w), (
        [str(x.message) for x in w])
