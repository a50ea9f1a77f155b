"""Shard-safety of the GPU pulse kernel.

integrate_pulse_pallas(mesh=...) runs the kernel PER SHARD of the 'data'
axis under jax.shard_map, so no batch data crosses devices. These tests pin
bitwise equality with the unsharded path: deterministic (each env's
integration is independent) for the +z-specialized RHS, the general
tilted-axis RHS and per-env params, and thermal (the noise is keyed by the
GLOBAL env index, so every env draws the same noise sharded or not).

The zero-collectives HLO assertion with the kernel ENGAGED lives in
tests/integration/test_sharding.py::test_sharded_step_pallas_zero_collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from spintorque_tpu.ops.pallas_integrator import (
    integrate_pulse_pallas,
    interpret_mode,
)
from spintorque_tpu.parallel import make_mesh
from spintorque_tpu.physics import IntegratorConfig, LLGSParams

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (fake) devices"
)

PARAMS = LLGSParams(
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    volume=1e-23,
    polarization=0.7,
    easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
).astype(jnp.float32)


def _setup(B=256, seed=0):
    key = jax.random.PRNGKey(seed)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    spans = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32,
                               5e-11, 3e-10)
    cur = jax.random.uniform(jax.random.fold_in(key, 2), (B,), jnp.float32,
                             -200.0, 200.0)
    return (m[:, 0], m[:, 1], m[:, 2]), spans, cur


def _assert_bitwise_equal(sharded, unsharded):
    (sx, sy, sz), sn, sdt, sfailed = sharded
    (ux, uy, uz), un, udt, ufailed = unsharded
    np.testing.assert_array_equal(np.asarray(sx), np.asarray(ux))
    np.testing.assert_array_equal(np.asarray(sy), np.asarray(uy))
    np.testing.assert_array_equal(np.asarray(sz), np.asarray(uz))
    np.testing.assert_array_equal(np.asarray(sn), np.asarray(un))
    np.testing.assert_array_equal(np.asarray(sdt), np.asarray(udt))
    np.testing.assert_array_equal(np.asarray(sfailed), np.asarray(ufailed))


def test_sharded_matches_unsharded_deterministic():
    m0, spans, cur = _setup()
    cfg = IntegratorConfig(method="rk4", max_substeps=512)
    mesh = make_mesh()
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg)
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, mesh=mesh)
    _assert_bitwise_equal(out, ref)


def test_sharded_matches_unsharded_tilted_axis():
    """General-RHS operand layout (3 extra easy-axis arrays) under shard_map."""
    m0, spans, cur = _setup(B=128)
    tilted = PARAMS.replace(
        easy_axis=jnp.array([0.6, 0.0, 0.8], jnp.float32)
    )
    cfg = IntegratorConfig(method="rk4", max_substeps=512)
    mesh = make_mesh()
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, tilted, cfg)
        out = integrate_pulse_pallas(m0, spans, cur, tilted, cfg, mesh=mesh)
    _assert_bitwise_equal(out, ref)


def test_sharded_per_env_params_ride_local_sort():
    """(B,) per-env parameters must reach THEIR env inside each shard."""
    B = 64
    m0, spans, cur = _setup(B=B)
    per_env = PARAMS.replace(
        uniaxial_anisotropy=jnp.linspace(8e5, 1.6e6, B, dtype=jnp.float32),
        damping=jnp.linspace(0.008, 0.02, B, dtype=jnp.float32),
    )
    cfg = IntegratorConfig(method="rk4", max_substeps=512)
    mesh = make_mesh()
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, per_env, cfg)
        out = integrate_pulse_pallas(m0, spans, cur, per_env, cfg, mesh=mesh)
    _assert_bitwise_equal(out, ref)


def test_single_data_axis_skips_shard_map():
    """A mesh whose 'data' axis is 1 wide must take the plain path (no
    shard_map tracing overhead, no behavior change)."""
    m0, spans, cur = _setup(B=64)
    cfg = IntegratorConfig(method="euler", max_substeps=128)
    mesh = make_mesh(n_data=1, n_model=8)
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg)
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, mesh=mesh)
    _assert_bitwise_equal(out, ref)


def test_sharded_thermal_runs():
    """Thermal kernel under shard_map draws exactly the unsharded noise:
    bitwise-equal results, finite unit-norm output, no failures."""
    _check_sharded_thermal("per_substep")


def test_sharded_thermal_per_stage_matches_unsharded():
    _check_sharded_thermal("per_stage")


def _check_sharded_thermal(rk4_noise):
    m0, spans, cur = _setup(B=128)
    cfg = IntegratorConfig(
        method="rk4", max_substeps=512, thermal=True,
        noise_mode="reference", rk4_noise=rk4_noise,
    )
    mesh = make_mesh()
    key = jax.random.PRNGKey(3)
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, key=key)
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, key=key, mesh=mesh)
    _assert_bitwise_equal(out, ref)
    (mx, my, mz), n, dt, failed = out
    m = np.stack([np.asarray(mx), np.asarray(my), np.asarray(mz)], -1)
    assert np.all(np.isfinite(m))
    np.testing.assert_allclose(np.linalg.norm(m, axis=-1), 1.0, atol=1e-5)
    assert not np.asarray(failed).any()


def test_thermal_noise_is_keyed_by_global_env_index():
    """Every env draws its own noise: with equal states and spans in every
    lane, two envs that shared a key would end in the same state."""
    B = 64
    m = jnp.tile(jnp.asarray([[0.6, 0.0, 0.8]], jnp.float32), (B, 1))
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jnp.full((B,), 1e-10, jnp.float32)
    cur = jnp.zeros((B,), jnp.float32)
    cfg = IntegratorConfig(method="heun", max_substeps=128, thermal=True,
                           noise_mode="physical")
    key = jax.random.PRNGKey(11)
    with interpret_mode():
        (fx, _, _), *_ = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, key=key)
    fx = np.asarray(fx)
    assert len(np.unique(fx)) == B, "two envs drew the same noise"


def test_indivisible_batch_falls_back_to_unsharded():
    """B not divisible by the 'data' axis was never shardable (shard_env_state
    replicates such batches); the fast path must fall back to the plain jit
    path instead of crashing in shard_map at trace time (review finding)."""
    m0, spans, cur = _setup(B=100)
    cfg = IntegratorConfig(method="rk4", max_substeps=512)
    mesh = make_mesh()
    with interpret_mode():
        ref = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg)
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg, mesh=mesh)
    _assert_bitwise_equal(out, ref)
