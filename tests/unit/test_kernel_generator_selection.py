"""The GPU kernel's counter-based generator and its platform selection."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng

from spintorque_tpu.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu.ops import pallas_integrator as pi
from spintorque_tpu.physics import IntegratorConfig


def _bits(n, seed=0):
    k0, k1 = pi.env_keys(jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.uint32))
    return k0, k1


def test_threefry_matches_jax_random_bitwise():
    """The in-kernel hash is jax.random's Threefry-2x32, bit for bit."""
    key = jnp.asarray([0x12345678, 0x9ABCDEF0], jnp.uint32)
    x0 = jnp.arange(257, dtype=jnp.uint32) * np.uint32(2654435761)
    x1 = jnp.arange(257, dtype=jnp.uint32) ^ np.uint32(0xDEADBEEF)
    want = np.asarray(prng.threefry_2x32(key, jnp.concatenate([x0, x1])))
    got0, got1 = pi.threefry2x32(key[0], key[1], x0, x1)
    np.testing.assert_array_equal(np.concatenate([np.asarray(got0), np.asarray(got1)]), want)


def test_uniforms_are_uniform():
    """Mantissa-bitcast uniforms: in [0, 1), flat histogram, right moments."""
    from scipy import stats

    k0, k1 = _bits(1 << 16)
    b0, b1 = pi.threefry2x32(k0, k1, jnp.zeros_like(k0), jnp.zeros_like(k0))
    u = np.concatenate([np.asarray(pi._uniform(b0)), np.asarray(pi._uniform(b1))])
    assert u.min() >= 0.0 and u.max() < 1.0
    n = u.size
    assert abs(u.mean() - 0.5) < 5 * math.sqrt(1 / 12 / n)
    counts, _ = np.histogram(u, bins=64, range=(0.0, 1.0))
    assert stats.chisquare(counts).pvalue > 1e-4
    assert stats.kstest(u, "uniform").pvalue > 1e-4


def test_normals_independent_across_draws_substeps_and_envs():
    """Normals of neighbouring envs, substeps and draws are uncorrelated."""
    B = 1 << 14
    k0, k1 = _bits(B, seed=3)
    cfg = IntegratorConfig(method="rk4", thermal=True, rk4_noise="per_stage")
    s0 = pi.substep_normals(k0, k1, 0, cfg)
    s1 = pi.substep_normals(k0, k1, 1, cfg)
    series = [np.asarray(c) for f in s0 + s1 for c in f]
    assert len(series) == 24
    corr = np.corrcoef(np.stack(series))
    off = corr[~np.eye(len(series), dtype=bool)]
    assert np.abs(off).max() < 5.0 / math.sqrt(B)
    # neighbouring envs (lag-1 along the batch) are uncorrelated too
    a = series[0]
    assert abs(np.corrcoef(a[:-1], a[1:])[0, 1]) < 5.0 / math.sqrt(B)


def test_keys_depend_on_seed_and_global_index():
    """Index keying: the same env index under the same seed gives the same
    key wherever it sits; another index or another seed gives another."""
    idx = jnp.arange(64, dtype=jnp.uint32)
    a0, a1 = pi.env_keys(jax.random.PRNGKey(5), idx)
    b0, b1 = pi.env_keys(jax.random.PRNGKey(5), idx[32:])
    np.testing.assert_array_equal(np.asarray(a0[32:]), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(a1[32:]), np.asarray(b1))
    c0, _ = pi.env_keys(jax.random.PRNGKey(6), idx)
    assert len(set(np.asarray(a0).tolist())) == 64
    assert not np.any(np.asarray(a0) == np.asarray(c0))
    # typed keys give the same words as raw keys
    t0, _ = pi.env_keys(jax.random.key(5, impl="threefry2x32"), idx)
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(a0))


@pytest.mark.parametrize(
    "method,rk4_noise,draws",
    [("euler", "per_stage", 2), ("heun", "per_stage", 2),
     ("rk4", "per_substep", 2), ("rk4", "per_stage", 6)],
)
def test_draws_per_substep(method, rk4_noise, draws):
    cfg = IntegratorConfig(method=method, thermal=True, rk4_noise=rk4_noise)
    assert pi.draws_per_substep(cfg) == draws


def test_selection_by_platform_on_cpu():
    """On the CPU backend: auto picks XLA, False picks XLA, True raises."""
    assert jax.default_backend() == "cpu"
    assert pi.select_kernel(None, True) is False
    assert pi.select_kernel(False, True) is False
    with pytest.raises(RuntimeError, match="GPU"):
        pi.select_kernel(True, True)


def test_selection_under_interpret_mode():
    """interpret_mode() is the explicit switch that makes the kernel
    selectable off a GPU; an unsupported configuration raises under True
    instead of silently falling back, and keeps XLA under auto."""
    with pi.interpret_mode():
        assert pi.kernel_platform()
        assert pi.select_kernel(True, True) is True
        assert pi.select_kernel(None, True) is True
        assert pi.select_kernel(None, False) is False
        assert pi.select_kernel(False, True) is False
        with pytest.raises(ValueError, match="does not cover"):
            pi.select_kernel(True, False)
    assert not pi.kernel_platform()


def test_env_use_pallas_true_raises_off_gpu():
    with pytest.raises(RuntimeError, match="GPU"):
        SpinTorqueEnv(batch_size=4, config=SpinTorqueEnvConfig(
            dtype="float32", use_pallas=True))
    env = SpinTorqueEnv(batch_size=4, config=SpinTorqueEnvConfig(dtype="float32"))
    assert env.config.use_pallas is False


def test_pallas_rejects_thermal_without_key():
    m = jnp.ones((8,), jnp.float32)
    cfg = IntegratorConfig(method="euler", thermal=True, max_substeps=16)
    from spintorque_tpu.physics import LLGSParams

    params = LLGSParams(800e3, 0.01, 1.2e6, 1e-23, 0.7, jnp.asarray([0.0, 0.0, 1.0]))
    with pytest.raises(ValueError, match="PRNG key"):
        with pi.interpret_mode():
            pi.integrate_pulse_pallas((0 * m, 0 * m, m), m * 1e-11, 0 * m, params, cfg)
