"""GPU pulse kernel vs XLA integrator agreement (Pallas interpreter on CPU)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spintorque_tpu.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu.ops import pallas_integrator as pi
from spintorque_tpu.ops.pallas_integrator import (
    integrate_pulse_pallas,
    interpret_mode,
    pallas_supported,
)

PARAMS = LLGSParams(
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    volume=1e-23,
    polarization=0.7,
    easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
)


def _setup(B=256, seed=0):
    key = jax.random.PRNGKey(seed)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    spans = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32,
                               5e-11, 3e-10)
    cur = jax.random.uniform(jax.random.fold_in(key, 2), (B,), jnp.float32,
                             -200.0, 200.0)
    return (m[:, 0], m[:, 1], m[:, 2]), spans, cur


def _assert_close(pallas_out, ref):
    (px, py, pz), n, dt, failed = pallas_out
    np.testing.assert_allclose(np.asarray(px), np.asarray(ref.m[0]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(py), np.asarray(ref.m[1]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(pz), np.asarray(ref.m[2]), rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(n), np.asarray(ref.n_substeps))
    np.testing.assert_array_equal(np.asarray(failed), np.asarray(ref.failed))


def test_pallas_supported_gate():
    cfg = IntegratorConfig(method="rk4")
    assert pallas_supported(PARAMS, cfg, jnp.float32)
    assert not pallas_supported(PARAMS, cfg, jnp.float64)
    # Tilted / per-env axes are covered by the general-RHS kernel.
    tilted = PARAMS.replace(easy_axis=jnp.array([1.0, 0.0, 0.0], jnp.float32))
    assert pallas_supported(tilted, cfg, jnp.float32)
    per_env = PARAMS.replace(
        easy_axis=jnp.tile(jnp.array([[0.6, 0.0, 0.8]], jnp.float32), (16, 1))
    )
    assert pallas_supported(per_env, cfg, jnp.float32)
    # Degenerate axes are not.
    bad = PARAMS.replace(easy_axis=jnp.zeros((3,), jnp.float32))
    assert not pallas_supported(bad, cfg, jnp.float32)
    assert pallas_supported(PARAMS, IntegratorConfig(method="heun"), jnp.float32)
    assert not pallas_supported(
        PARAMS, IntegratorConfig(method="dop853"), jnp.float32
    )


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_pallas_matches_xla_deterministic(method):
    m0, spans, cur = _setup()
    cfg = IntegratorConfig(method=method, max_substeps=512)
    ref = integrate_pulse(m0, spans, cur, PARAMS.astype(jnp.float32), cfg)
    with interpret_mode():
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS.astype(jnp.float32), cfg)
    _assert_close(out, ref)


@pytest.mark.parametrize("B", [1, 5, 200])
def test_pallas_odd_batch_sizes(B):
    """Batches that are not block multiples exercise the padding: padded
    lanes must neither run nor leak into the results (B=1: one real lane
    in a block; B=200: a partly filled last block)."""
    m0, spans, cur = _setup(B=B, seed=11)
    cfg = IntegratorConfig(method="rk4", max_substeps=256)
    ref = integrate_pulse(m0, spans, cur, PARAMS.astype(jnp.float32), cfg)
    with interpret_mode():
        out = integrate_pulse_pallas(m0, spans, cur, PARAMS.astype(jnp.float32), cfg)
    _assert_close(out, ref)


def test_pallas_matches_xla_tilted_axis():
    """General-RHS kernel: scalar tilted easy axis must match the XLA path."""
    m0, spans, cur = _setup(B=128, seed=7)
    tilted = PARAMS.replace(
        easy_axis=jnp.array([0.6, 0.0, 0.8], jnp.float32)
    ).astype(jnp.float32)
    cfg = IntegratorConfig(method="rk4", max_substeps=256)
    ref = integrate_pulse(m0, spans, cur, tilted, cfg)
    with interpret_mode():
        out = integrate_pulse_pallas(m0, spans, cur, tilted, cfg)
    _assert_close(out, ref)


def test_pallas_per_env_params_with_heterogeneous_spans():
    """Per-env (B,) physics params and per-env (B, 3) easy axes must reach
    their own lane, across blocks that run to different bounds."""
    B = 192
    m0, spans, cur = _setup(B=B, seed=11)
    key = jax.random.PRNGKey(99)
    axes = jax.random.normal(key, (B, 3), jnp.float32)
    axes = axes / jnp.linalg.norm(axes, axis=-1, keepdims=True)
    params = LLGSParams(
        saturation_magnetization=jax.random.uniform(
            jax.random.fold_in(key, 1), (B,), jnp.float32, 4e5, 1.2e6),
        damping=jax.random.uniform(
            jax.random.fold_in(key, 2), (B,), jnp.float32, 0.005, 0.05),
        uniaxial_anisotropy=jax.random.uniform(
            jax.random.fold_in(key, 3), (B,), jnp.float32, 3e5, 2e6),
        volume=jax.random.uniform(
            jax.random.fold_in(key, 4), (B,), jnp.float32, 5e-24, 5e-23),
        polarization=jax.random.uniform(
            jax.random.fold_in(key, 5), (B,), jnp.float32, 0.3, 0.9),
        easy_axis=axes,
    )
    cfg = IntegratorConfig(method="rk4", max_substeps=512)
    ref = integrate_pulse(m0, spans, cur, params, cfg)
    with interpret_mode():
        out = integrate_pulse_pallas(m0, spans, cur, params, cfg)
    _assert_close(out, ref)


def test_pallas_thermal_sigma_rides_the_sort(monkeypatch):
    """Half the envs run at T=0 (exactly deterministic), half at T=500 K.
    Spans are laid out ASCENDING and the duration sort is engaged (one
    'SM'), so the descending-n sort reverses the batch; if sigma were not
    permuted with the state, the wrong envs would receive noise. The T=0
    half must match the deterministic XLA result; the T=500 half must
    differ."""
    monkeypatch.setattr(pi, "_sm_count", lambda: 1)
    jax.clear_caches()
    B = 128
    key = jax.random.PRNGKey(5)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jnp.linspace(5e-11, 3e-10, B).astype(jnp.float32)  # ascending
    cur = jnp.full((B,), 150.0, jnp.float32)
    temp = jnp.where(jnp.arange(B) % 2 == 0, 0.0, 500.0).astype(jnp.float32)

    det_cfg = IntegratorConfig(method="heun", max_substeps=512)
    ref = integrate_pulse(m0, spans, cur, PARAMS.astype(jnp.float32), det_cfg)

    thermal_cfg = IntegratorConfig(
        method="heun", max_substeps=512, thermal=True, noise_mode="physical"
    )
    with interpret_mode():
        (px, py, pz), n, dt, failed = integrate_pulse_pallas(
            m0, spans, cur, PARAMS.astype(jnp.float32), thermal_cfg,
            key=jax.random.PRNGKey(42), temperature=temp,
        )
    cold = np.arange(B) % 2 == 0
    np.testing.assert_allclose(
        np.asarray(px)[cold], np.asarray(ref.m[0])[cold], rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(pz)[cold], np.asarray(ref.m[2])[cold], rtol=2e-6, atol=2e-6)
    hot_diff = np.abs(np.asarray(pz)[~cold] - np.asarray(ref.m[2])[~cold])
    assert hot_diff.max() > 1e-5, "T=500K envs produced no thermal deviation"


def test_pallas_freeze_flag_matches():
    """Large currents must produce the same failed flags as the XLA path."""
    B = 128
    key = jax.random.PRNGKey(3)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    spans = jnp.full((B,), 1e-10, jnp.float32)
    # half small (fine), half large (blow-up/freeze or fallback)
    cur = jnp.where(jnp.arange(B) % 2 == 0, 50.0, 1e6).astype(jnp.float32)
    cfg = IntegratorConfig(method="rk4", max_substeps=128)
    ref = integrate_pulse((m[:, 0], m[:, 1], m[:, 2]), spans, cur,
                          PARAMS.astype(jnp.float32), cfg)
    with interpret_mode():
        (px, py, pz), n, dt, failed = integrate_pulse_pallas(
            (m[:, 0], m[:, 1], m[:, 2]), spans, cur, PARAMS.astype(jnp.float32), cfg
        )
    np.testing.assert_array_equal(np.asarray(failed), np.asarray(ref.failed))
    np.testing.assert_allclose(np.asarray(px), np.asarray(ref.m[0]), rtol=2e-6, atol=2e-6)


def test_pallas_noise_statistics():
    """Moments and a KS test of the kernel's own noise: Threefry bits ->
    mantissa-bitcast uniforms -> Box-Muller, drawn inside a kernel. Also
    checks the field count per substep and that the components, fields and
    substeps are uncorrelated, for both RK4 sampling modes."""
    for rk4_noise in ("per_substep", "per_stage"):
        _check_kernel_noise(rk4_noise)


def _check_kernel_noise(rk4_noise):
    from scipy import stats

    cfg = IntegratorConfig(method="rk4", thermal=True, rk4_noise=rk4_noise)
    with interpret_mode():
        out = np.asarray(pi.sample_kernel_normals(cfg, jax.random.PRNGKey(7), 4096))
    assert out.shape[1] == (1 if rk4_noise == "per_substep" else 4)
    samples = out.ravel()
    n = samples.size
    assert np.all(np.isfinite(samples)), "non-finite normals from Box-Muller"
    assert abs(samples.mean()) < 5.0 / math.sqrt(n)
    assert abs(samples.std() - 1.0) < 5.0 / math.sqrt(2 * n)
    assert abs(stats.skew(samples)) < 0.12
    assert abs(stats.kurtosis(samples)) < 0.25
    ks = stats.kstest(samples, "norm")
    assert ks.pvalue > 1e-4, f"KS test rejects normality: {ks}"
    rows = out.reshape(-1, out.shape[-1])
    corr = np.corrcoef(rows)
    off = corr[~np.eye(len(rows), dtype=bool)]
    assert np.abs(off).max() < 5.0 / math.sqrt(out.shape[-1])


def test_pallas_matches_xla_randomized_configs():
    """Seeded randomized config sweep: for random (method, batch, axis,
    span-range, current-range, per-env-param) combinations, the Pallas
    kernel (interpret) must match the XLA path at the deterministic
    tolerance. Broadens the fixed-config parity tests above after the
    round-4 kernel restructures (chains/segments/delta-form)."""
    rng = np.random.default_rng(1234)
    for trial in range(6):
        B = int(rng.choice([32, 96, 256, 520]))
        method = str(rng.choice(["euler", "heun", "rk4"]))
        key = jax.random.PRNGKey(100 + trial)
        m = jax.random.normal(key, (B, 3), jnp.float32)
        m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
        m0 = (m[:, 0], m[:, 1], m[:, 2])
        lo = float(rng.uniform(1e-12, 1e-10))
        hi = float(rng.uniform(2e-10, 4e-10))
        spans = jax.random.uniform(jax.random.fold_in(key, 1), (B,),
                                   jnp.float32, lo, hi)
        cur = jax.random.uniform(jax.random.fold_in(key, 2), (B,),
                                 jnp.float32, -300.0, 300.0)
        params = PARAMS.astype(jnp.float32)
        if rng.random() < 0.5:
            axis = rng.normal(size=3)
            axis = axis / np.linalg.norm(axis)
            params = params.replace(
                easy_axis=jnp.asarray(axis, jnp.float32))
        if rng.random() < 0.5:
            params = params.replace(
                damping=jnp.asarray(
                    rng.uniform(0.005, 0.05, B), jnp.float32),
                uniaxial_anisotropy=jnp.asarray(
                    rng.uniform(8e5, 1.6e6, B), jnp.float32),
            )
        cfg = IntegratorConfig(method=method, max_substeps=512)
        ref = integrate_pulse(m0, spans, cur, params, cfg)
        with interpret_mode():
            out = integrate_pulse_pallas(m0, spans, cur, params, cfg)
        label = f"trial={trial} method={method} B={B}"
        for c in range(3):
            np.testing.assert_allclose(
                np.asarray(out[0][c]), np.asarray(ref.m[c]),
                rtol=2e-6, atol=2e-6, err_msg=label)
        np.testing.assert_array_equal(
            np.asarray(out[1]), np.asarray(ref.n_substeps), err_msg=label)
        np.testing.assert_array_equal(
            np.asarray(out[3]), np.asarray(ref.failed), err_msg=label)


@pytest.mark.parametrize(
    "batch,n_sm,shape",
    [(4096, 132, (32, 1, False)), (65536, 132, (128, 4, True)),
     (16384, 132, (32, 1, True)), (4224, 132, (32, 1, False)),
     (4225, 132, (32, 1, True)), (16896, 132, (128, 4, True))],
)
def test_launch_shape_rule(batch, n_sm, shape):
    """Narrow blocks without the sort while the blocks fit on the SMs;
    the duration sort once they queue; wide blocks once they fill them."""
    assert pi.launch_shape(batch, n_sm) == shape


@pytest.mark.parametrize("n_sm", [1, 3])
@pytest.mark.parametrize("thermal", [False, True])
def test_sorted_and_wide_launches_match_unsorted(monkeypatch, n_sm, thermal):
    """The duration sort and the wide blocks change only the order and
    grouping of lanes: per-env results are bitwise those of the narrow,
    unsorted launch, for per-env params, a tilted axis and thermal noise
    (keyed by env index, so it rides with its env through the sort)."""
    B = 200
    m0, spans, cur = _setup(B=B, seed=13)
    params = PARAMS.replace(
        easy_axis=jnp.asarray([0.6, 0.0, 0.8], jnp.float32),
        damping=jnp.linspace(0.005, 0.05, B, dtype=jnp.float32),
    ).astype(jnp.float32)
    cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=thermal,
                           rk4_noise="per_substep", noise_mode="physical")
    key = jax.random.PRNGKey(4)
    with interpret_mode():
        monkeypatch.setattr(pi, "_sm_count", lambda: 10_000)
        assert pi.launch_shape(B, pi._sm_count()) == (32, 1, False)
        ref = integrate_pulse_pallas(m0, spans, cur, params, cfg, key=key)
        monkeypatch.setattr(pi, "_sm_count", lambda: n_sm)
        assert pi.launch_shape(B, n_sm)[2], "sort did not engage"
        jax.clear_caches()
        out = integrate_pulse_pallas(m0, spans, cur, params, cfg, key=key)
    for c in range(3):
        np.testing.assert_array_equal(np.asarray(out[0][c]), np.asarray(ref[0][c]))
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(ref[3]))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(ref[1]))
    if not thermal:
        xla = integrate_pulse(m0, spans, cur, params, cfg)
        _assert_close(out, xla)
