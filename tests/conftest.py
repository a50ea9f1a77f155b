"""Test configuration.

Tests run on a fake 8-device CPU backend so that multi-device sharding
paths are exercised without an accelerator (__graft_entry__.dryrun_multichip
validates the same paths). float64 is enabled globally: parity tests against
the float64 NumPy reference need it, and all library code is dtype-explicit
so float32 paths remain covered.

Tests marked ``gpu`` need the card: they skip on the CPU and run on a GPU
host with ``SPINTORQUE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``,
which keeps JAX on its default (GPU) backend instead of the CPU.
"""

import os

# Must take effect before jax initializes its backends: set the variable
# and force the platform through jax.config as well (valid until the first
# backend initialization).
ON_GPU = os.environ.get("SPINTORQUE_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(42)


@pytest.fixture
def rng_key():
    return jax.random.PRNGKey(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with SPINTORQUE_TEST_PLATFORM=gpu on the card)")
    return jax.devices()[0]


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "parity: compares against the reference checkout")
    config.addinivalue_line("markers", "gpu: needs the GPU (skips on the CPU)")
