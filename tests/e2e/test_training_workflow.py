"""End-to-end training workflow tests (reference: tests/e2e/
test_training_workflow.py surface - random-policy loops, protocol
evaluation, analysis flows)."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.fixtures.device_configs import get_device_config, get_test_scenario
from tests.fixtures.sample_data import generate_pulse_protocol

from spintorque_tpu.envs import (
    GymSpinTorqueEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu.parallel import random_policy, rollout_jit, summarize


def test_random_policy_training_loop():
    """Random-policy rollout produces sane statistics end to end."""
    env = SpinTorqueEnv(
        batch_size=32,
        device_params=get_device_config("stt_mram"),
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-9,
                                   max_steps=20, dtype="float32"),
    )
    run = rollout_jit(env, random_policy(env), num_steps=40)
    state, obs = env.reset(jax.random.PRNGKey(0))
    state, obs, traj = run(None, state, obs, jax.random.PRNGKey(1))
    stats = summarize(traj)
    assert int(stats["episodes"]) > 0  # auto-reset cycled episodes
    assert 0.0 <= float(stats["success_rate"]) <= 1.0


def test_easy_switching_scenario():
    sc = get_test_scenario("easy_switching")
    env = GymSpinTorqueEnv(
        device_type=sc["device_type"], device_params=sc["device_params"],
        include_thermal_fluctuations=False, max_steps=sc["max_steps"],
    )
    obs, _ = env.reset(
        seed=0,
        options={"initial_state": sc["initial_state"],
                 "target_state": sc["target_state"]},
    )
    obs, r, te, tr, info = env.step(np.array([0.0, 1e-10]))
    assert te  # initial state aligned with target -> immediate success
    analysis = env.analyze_episode()
    assert analysis["success"] and analysis["switching_step"] == 1


def test_protocol_evaluation():
    """Replay a recorded pulse protocol; episode analysis is consistent."""
    env = GymSpinTorqueEnv(include_thermal_fluctuations=False, max_steps=10)
    env.reset(seed=3)
    protocol = generate_pulse_protocol(n_pulses=6, seed=4)
    total = 0.0
    for pulse in protocol:
        obs, r, te, tr, info = env.step(pulse.astype(np.float32))
        total += r
        if te or tr:
            break
    analysis = env.analyze_episode()
    np.testing.assert_allclose(
        analysis["average_reward"] * analysis["episode_length"], total, rtol=1e-6
    )


def test_domain_randomized_batch():
    """Per-env heterogeneous device parameters in one batch (the accelerator-native
    version of the reference's domain-randomization placeholder)."""
    B = 16
    key = jax.random.PRNGKey(0)
    env = SpinTorqueEnv(
        batch_size=B,
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-10,
                                   dtype="float32"),
    )
    damping = jax.random.uniform(key, (B,), jnp.float32, 0.005, 0.05)
    ku = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32,
                            0.8e6, 2e6)
    env.device_params = env.device_params.replace(
        damping=damping, uniaxial_anisotropy=ku
    )
    state, obs = env.reset(jax.random.PRNGKey(2))
    state, ts = env.step(state, jnp.zeros((B, 2), jnp.float32))
    assert np.isfinite(np.asarray(ts.obs)).all()
