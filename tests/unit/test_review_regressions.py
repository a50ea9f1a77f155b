"""Regression tests for code-review findings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spintorque_tpu.envs import (
    ArrayEnvConfig,
    SkyrmionEnvConfig,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu.physics import IntegratorConfig, LLGSParams, LLGSSolver, integrate_pulse

PARAMS = LLGSParams(
    saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
    volume=1e-23, polarization=0.7,
    easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
)


def test_pallas_prng_produces_proper_normals():
    """Finding: a signed-bits uniform made half the Box-Muller draws NaN,
    and the per-substep normalize fallback then silently reset the state.
    The kernel's thermal field must be finite, two-sided and spread out
    (interpret mode)."""
    from spintorque_tpu.ops.pallas_integrator import (
        integrate_pulse_pallas,
        interpret_mode,
    )

    B = 512
    m = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (B, 1))
    cfg = IntegratorConfig(method="euler", thermal=True, max_substeps=64)
    with interpret_mode():
        (px, py, pz), n, dt, failed = integrate_pulse_pallas(
            (m[:, 0], m[:, 1], m[:, 2]),
            jnp.full((B,), 5e-11, jnp.float32),
            jnp.zeros((B,), jnp.float32),
            PARAMS,
            cfg,
            key=jax.random.PRNGKey(0),
            temperature=300.0,
        )
    px, py = np.asarray(px), np.asarray(py)
    assert np.isfinite(px).all() and np.isfinite(py).all()
    assert np.isfinite(np.asarray(pz)).all()
    assert not np.asarray(failed).any()
    # Two-sided transverse kicks: both signs occur, and no env is reset to
    # exactly the pole.
    assert (px > 0).any() and (px < 0).any()
    assert (py > 0).any() and (py < 0).any()
    assert np.all(np.abs(px) > 0)


def test_single_env_pair_action():
    """Finding: B=1 env misparsed a (2,) [current, duration] action."""
    env = SpinTorqueEnv(
        batch_size=1,
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-9,
                                   dtype="float32", autoreset=False),
    )
    state, _ = env.reset(jax.random.PRNGKey(0))
    state, ts = env.step(state, jnp.asarray([1e5, 1e-10], jnp.float32))
    assert float(np.asarray(state.last_current)[0]) == pytest.approx(1e5)
    assert float(np.asarray(state.last_duration)[0]) == pytest.approx(1e-10)
    # mismatched 1-D length raises clearly
    env2 = SpinTorqueEnv(
        batch_size=4,
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-9,
                                   dtype="float32"),
    )
    state2, _ = env2.reset(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="does not match batch_size"):
        env2.step(state2, jnp.asarray([1e5, 1e-10], jnp.float32))


def test_solver_default_method_is_euler():
    """Finding: reference SimpleLLGSSolver defaults to 'euler'."""
    assert LLGSSolver().method == "euler"


def test_zero_span_nonfinite_input_falls_back():
    """Finding: inf input through the zero-span path returned NaN."""
    solver = LLGSSolver(dtype=jnp.float64)
    p = dict(damping=0.01, saturation_magnetization=800e3,
             uniaxial_anisotropy=1.2e6, volume=1e-23, polarization=0.7,
             easy_axis=np.array([0.0, 0.0, 1.0]))
    res = solver.solve(np.array([np.inf, 0.0, 0.0]), (0.0, 0.0), p)
    np.testing.assert_allclose(np.asarray(res["m"]), [0.0, 0.0, 1.0])


def test_clamped_substeps_integrate_full_span():
    """Finding: n clamping silently truncated the pulse; now dt coarsens so
    the full span is integrated."""
    B = 2
    m = jnp.tile(jnp.asarray([[0.3, 0.0, 0.954]], jnp.float64), (B, 1))
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    span = jnp.full((B,), 1e-9, jnp.float64)  # law wants n=1000
    cur = jnp.zeros((B,), jnp.float64)
    capped = integrate_pulse(
        (m[:, 0], m[:, 1], m[:, 2]), span, cur, PARAMS.astype(jnp.float64),
        IntegratorConfig(method="rk4", max_substeps=500),
    )
    assert int(capped.n_substeps[0]) == 500
    np.testing.assert_allclose(float(capped.dt[0]), 1e-9 / 500, rtol=1e-12)
    # Full-span coarse integration lands near the fine-step result
    # (relaxation toward +z), NOT near the half-span state.
    fine = integrate_pulse(
        (m[:, 0], m[:, 1], m[:, 2]), span, cur, PARAMS.astype(jnp.float64),
        IntegratorConfig(method="rk4", max_substeps=1024),
    )
    np.testing.assert_allclose(
        float(capped.m[2][0]), float(fine.m[2][0]), rtol=1e-3
    )


def test_array_env_running_normalized_reward():
    """Finding: string normalize modes crashed the array/skyrmion envs."""
    env = SpinTorqueArrayEnv(
        batch_size=2,
        reward_components={
            "energy": {"weight": 1.0, "function": "energy",
                       "normalize": "running_std"},
        },
        config=ArrayEnvConfig(dtype="float64", autoreset=False,
                              action_mode="global"),
    )
    state, _ = env.reset(jax.random.PRNGKey(0))
    for _ in range(3):
        state, ts = env.step(state, jnp.asarray([[0.0, 1e5]] * 2, jnp.float64))
    assert np.isfinite(np.asarray(ts.reward)).all()
    assert "energy" in state.reward_stats


def test_skyrmion_env_running_normalized_reward_and_target_override():
    env = SkyrmionRacetrackEnv(
        batch_size=2,
        reward_components={
            "stability": {
                "weight": 1.0,
                "function": lambda ctx: ctx.extras["stability_factors"].mean(-1),
                "normalize": "running_mean",
            },
        },
        config=SkyrmionEnvConfig(dtype="float64", autoreset=False,
                                 include_thermal=False, include_pinning=False),
    )
    state, _ = env.reset(jax.random.PRNGKey(0))
    state, ts = env.step(state, jnp.zeros((2, 5), jnp.float64))
    assert np.isfinite(np.asarray(ts.reward)).all()

    # Finding: target override was a stale jit constant.
    from spintorque_tpu.envs import GymSkyrmionRacetrackEnv

    g = GymSkyrmionRacetrackEnv(include_thermal_fluctuations=False,
                                include_pinning=False)
    obs1, _ = g.reset(seed=0, options={
        "initial_positions": np.array([[500e-9, 100e-9]]),
        "target_positions": [500e-9],
    })
    # At the target -> success immediately.
    obs, r, te, tr, info = g.step(np.zeros(5, np.float32))
    assert te
    obs2, _ = g.reset(seed=0, options={
        "initial_positions": np.array([[500e-9, 100e-9]]),
        "target_positions": [900e-9],
    })
    obs, r2, te2, tr2, info2 = g.step(np.zeros(5, np.float32))
    assert not te2  # 400 nm away from the overridden target
    assert info2["average_error"] > 1e-7


def test_pallas_rejects_unknown_noise_mode():
    from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas

    B = 128
    m = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (B, 1))
    with pytest.raises(ValueError, match="noise_mode"):
        integrate_pulse_pallas(
            (m[:, 0], m[:, 1], m[:, 2]),
            jnp.full((B,), 1e-11, jnp.float32),
            jnp.zeros((B,), jnp.float32),
            PARAMS,
            IntegratorConfig(method="rk4", thermal=True, noise_mode="typo",
                             max_substeps=32),
            key=jax.random.PRNGKey(0),
        )
