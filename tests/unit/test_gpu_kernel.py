"""The pulse kernel as compiled for the card (Triton), against XLA.

Marked ``gpu``: these skip on the CPU and run on a GPU host with
``SPINTORQUE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spintorque_tpu.envs import SpinTorqueEnv
from spintorque_tpu.ops import pallas_integrator as pi
from spintorque_tpu.physics import IntegratorConfig, LLGSParams, integrate_pulse

pytestmark = pytest.mark.gpu

PARAMS = LLGSParams(800e3, 0.01, 1.2e6, 1e-23, 0.7,
                    jnp.asarray([0.0, 0.0, 1.0], jnp.float32)).astype(jnp.float32)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_compiled_kernel_matches_xla(gpu, method):
    B = 4096
    key = jax.random.PRNGKey(0)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32, 1e-12, 5e-10)
    cur = jax.random.uniform(jax.random.fold_in(key, 2), (B,), jnp.float32, -2e6, 2e6)
    cfg = IntegratorConfig(method=method, max_substeps=512)
    out = pi.integrate_pulse_pallas(m0, spans, cur, PARAMS, cfg)
    ref = integrate_pulse(m0, spans, cur, PARAMS, cfg)
    for c in range(3):
        np.testing.assert_allclose(np.asarray(out[0][c]), np.asarray(ref.m[c]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(ref.failed))


def test_compiled_noise_moments(gpu):
    cfg = IntegratorConfig(method="rk4", thermal=True, rk4_noise="per_substep")
    z = np.asarray(pi.sample_kernel_normals(cfg, jax.random.PRNGKey(1), 1 << 16))
    n = z.size
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 5 / np.sqrt(n)
    assert abs(z.std() - 1) < 5 / np.sqrt(2 * n)


def test_env_selects_kernel_on_gpu(gpu):
    env = SpinTorqueEnv(batch_size=64)
    assert env.config.use_pallas is True
