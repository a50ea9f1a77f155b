"""RK4 thermal-noise sampling modes: 'per_stage' (reference parity) vs
'per_substep' (standard SDE treatment, 4x cheaper sampling — see
IntegratorConfig.rk4_noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spintorque_tpu.physics.integrator as integ
from spintorque_tpu.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas, interpret_mode

PARAMS = LLGSParams(
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    volume=1e-23,
    polarization=0.7,
    easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
).astype(jnp.float32)


def _setup(B=64, seed=2):
    key = jax.random.PRNGKey(seed)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    spans = jnp.full((B,), 2e-10, jnp.float32)
    cur = jnp.full((B,), 100.0, jnp.float32)
    return (m[:, 0], m[:, 1], m[:, 2]), spans, cur


def test_per_substep_draws_one_field_per_substep(monkeypatch):
    """The sampling contract itself: per_substep must request exactly ONE
    stage draw from the noise source; per_stage requests four."""
    calls = []
    orig = integ._stage_noise

    def spy(key, i, n, shape, dtype):
        calls.append(n)
        return orig(key, i, n, shape, dtype)

    monkeypatch.setattr(integ, "_stage_noise", spy)
    jax.clear_caches()
    m0, spans, cur = _setup()
    key = jax.random.PRNGKey(0)

    for mode, expect in (("per_substep", {1}), ("per_stage", {4})):
        calls.clear()
        cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True,
                               rk4_noise=mode)
        integrate_pulse(m0, spans, cur, PARAMS, cfg, key=key)
        assert set(calls) == expect, (mode, calls)
    jax.clear_caches()  # drop traces that captured the spy


def test_per_substep_differs_but_cold_envs_match_deterministic():
    m0, spans, cur = _setup()
    key = jax.random.PRNGKey(0)
    det = integrate_pulse(
        m0, spans, cur, PARAMS, IntegratorConfig(method="rk4", max_substeps=256)
    )
    # T=0: thermal machinery active but sigma=0 -> identical to deterministic
    for mode in ("per_stage", "per_substep"):
        cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True,
                               rk4_noise=mode)
        out = integrate_pulse(m0, spans, cur, PARAMS, cfg, key=key,
                              temperature=0.0)
        np.testing.assert_allclose(np.asarray(out.m[2]), np.asarray(det.m[2]),
                                   rtol=1e-6, atol=1e-7)
    # T=300: the two modes consume different draw counts -> different paths
    outs = {}
    for mode in ("per_stage", "per_substep"):
        cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True,
                               rk4_noise=mode)
        out = integrate_pulse(m0, spans, cur, PARAMS, cfg, key=key)
        assert np.isfinite(np.asarray(out.m[2])).all()
        outs[mode] = np.asarray(out.m[2])
    assert np.abs(outs["per_stage"] - outs["per_substep"]).max() > 1e-7


def test_per_substep_restores_full_noise_variance():
    """Per-stage iid draws average through the RK4 weights: the effective
    per-substep field variance deflates to sum(w^2) = (1+4+4+1)/36 = 10/36.
    per_substep keeps variance 1. Measured through the integrator on a
    nearly-free layer (tiny anisotropy, zero current), the per-substep
    trajectories must spread ~sqrt(36/10) ≈ 1.9x wider."""
    B = 2048
    key = jax.random.PRNGKey(9)
    m0 = (jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.float32),
          jnp.ones((B,), jnp.float32))
    spans = jnp.full((B,), 5e-11, jnp.float32)
    cur = jnp.zeros((B,), jnp.float32)
    soft = PARAMS.replace(uniaxial_anisotropy=jnp.float32(1.0))
    spread = {}
    for mode in ("per_stage", "per_substep"):
        cfg = IntegratorConfig(method="rk4", max_substeps=128, thermal=True,
                               noise_mode="physical", rk4_noise=mode)
        out = integrate_pulse(m0, spans, cur, soft, cfg, key=key,
                              temperature=300.0)
        # polar deviation from +z accumulates the thermal kicks
        spread[mode] = float(np.var(np.arccos(np.clip(np.asarray(out.m[2]),
                                                      -1.0, 1.0))))
    ratio = spread["per_substep"] / spread["per_stage"]
    assert 2.4 < ratio < 5.4, f"variance ratio {ratio} (expect ~3.6)"


def test_unknown_rk4_noise_raises():
    m0, spans, cur = _setup(B=8)
    cfg = IntegratorConfig(method="rk4", max_substeps=64, thermal=True,
                           rk4_noise="bogus")
    with pytest.raises(ValueError, match="rk4_noise"):
        integrate_pulse(m0, spans, cur, PARAMS, cfg, key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="rk4_noise"):
        with interpret_mode():
            integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg,
                                   key=jax.random.PRNGKey(0))


def test_pallas_per_substep_cold_envs_match():
    """Kernel path in per_substep mode: T=0 envs must equal the
    deterministic XLA result; T=500 envs must deviate.

    Uses a nearly-free layer (tiny anisotropy, zero current): with the
    canned stt_mram parameters the rk4 endpoint saturates to exactly
    mz=±1, an attractor that swallows any thermal perturbation and makes
    the endpoint comparison insensitive."""
    B = 128
    key = jax.random.PRNGKey(5)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jnp.linspace(5e-11, 3e-10, B).astype(jnp.float32)
    cur = jnp.zeros((B,), jnp.float32)
    temp = jnp.where(jnp.arange(B) % 2 == 0, 0.0, 500.0).astype(jnp.float32)
    soft = PARAMS.replace(uniaxial_anisotropy=jnp.float32(1.0))

    det = integrate_pulse(m0, spans, cur, soft,
                          IntegratorConfig(method="rk4", max_substeps=512))
    cfg = IntegratorConfig(method="rk4", max_substeps=512, thermal=True,
                           noise_mode="physical", rk4_noise="per_substep")
    with interpret_mode():
        (px, py, pz), n, dt, failed = integrate_pulse_pallas(
            m0, spans, cur, soft, cfg, key=jax.random.PRNGKey(42),
            temperature=temp,
        )
    cold = np.arange(B) % 2 == 0
    np.testing.assert_allclose(np.asarray(pz)[cold],
                               np.asarray(det.m[2])[cold],
                               rtol=2e-6, atol=2e-6)
    hot_diff = np.abs(np.asarray(pz)[~cold] - np.asarray(det.m[2])[~cold])
    assert hot_diff.max() > 1e-5


def test_env_default_is_per_substep_library_default_is_per_stage():
    """Defaults contract: env tier uses the physically-correct sampling
    (docs/REFERENCE_PARITY.md); the library IntegratorConfig keeps the
    reference-parity default for solver-level work."""
    from spintorque_tpu.envs import SpinTorqueEnvConfig

    env_cfg = SpinTorqueEnvConfig()
    assert env_cfg.rk4_noise == "per_substep"
    assert env_cfg.integrator().rk4_noise == "per_substep"
    assert IntegratorConfig().rk4_noise == "per_stage"

    import gymnasium as gym
    from spintorque_tpu.registration import register_envs

    # Parity tests import the reference package, which overrides the same ids
    # in gymnasium's process-global registry; force ours back.
    register_envs(force=True)
    env = gym.make("SpinTorque-v0")
    assert env.unwrapped.get_solver_info()["rk4_noise"] == "per_substep"
