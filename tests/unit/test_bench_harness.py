"""The headline measurement program (bench.measure_env_throughput) must run
on any backend and report sane rates — the ladder, chip_smoke.py's timing
phase and the headline are all produced by this exact function, so a
regression here silently invalidates the recorded performance story.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from bench import REFERENCE_STEPS_PER_S, measure_env_throughput
from spintorque_tpu.envs import SpinTorqueEnv, SpinTorqueEnvConfig


def test_measure_env_throughput_cpu_smoke():
    env = SpinTorqueEnv(
        batch_size=64,
        config=SpinTorqueEnvConfig(
            dtype="float32", include_thermal=False, max_duration=1e-10
        ),
    )
    rates, steps_per_block = measure_env_throughput(
        env, n_inner=2, warmup=2, blocks=2, iters_per_block=2
    )
    assert steps_per_block == 2 * 2 * 64
    assert len(rates) == 2
    assert all(np.isfinite(r) and r > 0 for r in rates)
    # Even the CPU backend at B=64 must clear the reference's measured rate.
    assert min(rates) > REFERENCE_STEPS_PER_S


def test_measured_batch_stays_sharded():
    """The measured program must keep the batch SHARDED across all mesh
    devices end-to-end - if it silently replicated, every chip would do all
    the work and bench.main's per-chip division would inflate the headline
    by the device count."""
    import jax

    if jax.device_count() < 8:
        import pytest

        pytest.skip("needs 8 fake devices")
    B = 64
    env = SpinTorqueEnv(
        batch_size=B,
        config=SpinTorqueEnvConfig(
            dtype="float32", include_thermal=False, max_duration=1e-10
        ),
    )
    rates, _, final_obs = measure_env_throughput(
        env, n_inner=2, warmup=1, blocks=1, iters_per_block=1,
        return_final=True,
    )
    assert rates[0] > 0
    n_dev = jax.device_count()
    assert not final_obs.sharding.is_fully_replicated
    shards = final_obs.addressable_shards
    assert len(shards) == n_dev
    for s in shards:
        assert s.data.shape == (B // n_dev,) + final_obs.shape[1:]


def test_headline_scan_length_matches_production_rollout():
    """The headline program's documented rationale is that its scan length
    equals the production PPO rollout length; enforce the contract so the
    two cannot drift silently (dispatch amortization is part of what the
    headline measures)."""
    import inspect

    from spintorque_tpu.rl import PPOConfig
    from spintorque_tpu.utils.benchmark import measure_env_throughput

    default_n_inner = inspect.signature(
        measure_env_throughput
    ).parameters["n_inner"].default
    assert default_n_inner == PPOConfig().rollout_steps == 16
