"""Statistical validation of noise_mode='physical' (round-3 verdict #5).

Two tests pin the thermal PHYSICS of the headline stochastic integrator
(stochastic Heun + the Brown discretization sigma = sqrt(2 alpha k_B T /
(gamma mu0 Ms V dt)), physics/integrator.py:122-123), not just
mode-to-mode variance ratios:

1. **Equilibrium**: a long Heun run of a small-Delta macrospin must sample
   the Boltzmann distribution p(m_z) ~ exp(-E(m_z)/kT). The energy matching
   the hot-loop RHS (llgs.py: h = h_k (m.e)e - Ms m_z z) is
   E = -(K_u - mu0 Ms^2/2) V m_z^2, so with the uniform-on-the-sphere
   measure (m_z uniform), p(m_z) ~ exp(Delta_eff m_z^2),
   Delta_eff = K_eff V / (k_B T). KS test + second-moment check.

2. **Switching rate vs Neel-Brown**: starting from the +z well, the
   ensemble <m_z>(t) decays at the slowest eigenvalue lambda_1 of Brown's
   axially-symmetric Fokker-Planck operator
       dP/dt = d/dx [ D (1-x^2) (dP/dx - 2 sigma x P) ],  x = m_z,
       D = alpha gamma k_B T / ((1+alpha^2) mu0 Ms V)
   (thermal_model.py:67-73 is the sigma this discretizes; Neel-Brown
   switching IS this operator's interwell mode). lambda_1 is computed
   numerically EXACTLY (finite-volume matrix + eig) - no asymptotic
   Arrhenius-prefactor guesswork - and compared to the measured decay at
   TWO barrier heights, which also pins the exp(-Delta) barrier dependence.

Calibration runs (B=4096, dt=2e-13): measured/predicted rate ratios were
1.058 (sigma=1.5) and 1.023 (sigma=2.5); the equilibrium KS p-value was
0.52 at alpha=0.1 and 0.38 at alpha=0.5 (confirming NO (1+alpha^2) factor
belongs in the field variance for this Gilbert-gamma formulation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate as sp_integrate
from scipy import stats

from spintorque_tpu.constants import GAMMA, KB_SOLVER, MU0
from spintorque_tpu.physics import IntegratorConfig, LLGSParams
from spintorque_tpu.physics.integrator import integrate_pulse

MS = 800e3
VOL = 1e-25
TEMP = 300.0
KT = KB_SOLVER * TEMP
K_DEMAG = 0.5 * MU0 * MS**2  # the RHS's -Ms m_z z term as an energy


def _params(delta_eff, alpha):
    """LLGSParams whose EFFECTIVE easy-axis barrier is delta_eff * kT."""
    k_u = delta_eff * KT / VOL + K_DEMAG
    return LLGSParams(
        saturation_magnetization=MS, damping=alpha,
        uniaxial_anisotropy=k_u, volume=VOL, polarization=0.7,
        easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
    ).astype(jnp.float32)


def _config(dt, span):
    return IntegratorConfig(
        method="heun", max_step=dt, max_substeps=int(span / dt) + 10,
        thermal=True, noise_mode="physical",
    )


def boltzmann_gate(*, delta, alpha, dt, span, B, seed, n_grid, ks_min, m2_tol,
                   use_pallas=False):
    """Run a Heun ensemble from uniform m to equilibrium and assert that
    m_z samples p(m_z) ~ exp(delta m_z^2). Returns (KS p-value, <m_z^2>,
    its theoretical value)."""
    key = jax.random.PRNGKey(seed)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    res = integrate_pulse(
        (m[:, 0], m[:, 1], m[:, 2]),
        jnp.full((B,), span, jnp.float32), jnp.zeros((B,), jnp.float32),
        _params(delta, alpha), _config(dt, span)._replace(use_pallas=use_pallas),
        key=jax.random.fold_in(key, 99), temperature=TEMP,
    )
    assert not bool(res.failed.any())
    mz = np.asarray(res.m[2])

    xs = np.linspace(-1.0, 1.0, n_grid)
    pdf = np.exp(delta * xs**2)
    cdf = sp_integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    ks = stats.kstest(mz, lambda v: np.interp(v, xs, cdf))
    assert ks.pvalue > ks_min, f"m_z distribution rejects Boltzmann: {ks}"
    m2_theory = np.trapezoid(xs**2 * pdf, xs) / np.trapezoid(pdf, xs)
    m2 = float((mz**2).mean())
    assert abs(m2 - m2_theory) < m2_tol, (m2, m2_theory)
    return float(ks.pvalue), m2, float(m2_theory)


def neel_brown_gate(*, alpha, dt, B, sigma, n_fp, per_tau, chunks, seed,
                    min_points, lo, hi, use_pallas=False):
    """Start B macrospins in the +z well, sample <m_z>(t) at ``chunks``
    pulse ends, and assert that its decay rate over the Fokker-Planck
    lambda_1 lies in (lo, hi). Returns the ratio."""
    D = alpha * GAMMA * KT / ((1 + alpha**2) * MU0 * MS * VOL)
    lam = _fp_lambda1(sigma, D, n=n_fp)
    chunk = 1.0 / (per_tau * lam)
    params = _params(sigma, alpha)
    cfg = _config(dt, chunk)._replace(use_pallas=use_pallas)
    key = jax.random.PRNGKey(seed)
    mx = jnp.zeros((B,), jnp.float32)
    my = jnp.zeros((B,), jnp.float32)
    mz = jnp.ones((B,), jnp.float32)  # all in the +z well
    spans = jnp.full((B,), chunk, jnp.float32)
    cur = jnp.zeros((B,), jnp.float32)
    means = []
    for k in range(chunks):
        res = integrate_pulse(
            (mx, my, mz), spans, cur, params, cfg,
            key=jax.random.fold_in(key, k), temperature=TEMP,
        )
        mx, my, mz = res.m
        means.append(float(jnp.mean(mz)))
    means = np.asarray(means)
    ts = (np.arange(chunks) + 1) * chunk
    mask = (means > 0.05) & (means < 0.95)
    assert mask.sum() >= min_points, means
    rate = -np.polyfit(ts[mask], np.log(means[mask]), 1)[0]
    ratio = rate / lam
    assert lo < ratio < hi, (
        f"sigma={sigma}: measured rate {rate:.3e} vs Neel-Brown "
        f"lambda_1 {lam:.3e} (ratio {ratio:.3f})"
    )
    return float(ratio)


# Full-size gates (calibration sizes above); chip_smoke.py runs these with
# the GPU kernel engaged.
BOLTZMANN_FULL = dict(delta=1.5, alpha=0.1, dt=1e-13, span=2.5e-9, B=4096,
                      seed=0, n_grid=4001, ks_min=1e-3, m2_tol=0.02)
NEEL_BROWN_FULL = [
    dict(alpha=0.5, dt=2e-13, B=2048, sigma=sigma, n_fp=600, per_tau=12.0,
         chunks=9, seed=7000 + int(sigma * 10), min_points=4, lo=0.7, hi=1.4)
    for sigma in (1.5, 2.5)
]


def _fp_lambda1(sigma, D, n=600):
    """Slowest relaxation eigenvalue of Brown's 1-D Fokker-Planck operator
    (finite-volume; detailed-balance flux F = a(x) ps(x) d(P/ps)/dx with
    a = D (1-x^2), ps ~ exp(sigma x^2) - exact to discretization, no
    Arrhenius asymptotics)."""
    x = np.linspace(-1.0, 1.0, n + 1)  # faces
    xc = 0.5 * (x[1:] + x[:-1])
    dx = x[1] - x[0]
    a_f = D * (1.0 - x**2)
    ps = np.exp(sigma * xc**2)
    A = np.zeros((n, n))
    for i in range(1, n):  # interior faces; boundary flux = 0 (a=0 there)
        c = a_f[i] * np.exp(sigma * x[i] ** 2) / dx
        A[i, i] -= c / ps[i] / dx
        A[i, i - 1] += c / ps[i - 1] / dx
        A[i - 1, i] += c / ps[i] / dx
        A[i - 1, i - 1] -= c / ps[i - 1] / dx
    ev = np.sort(np.linalg.eigvals(A).real)
    return -ev[-2]  # largest is ~0 (stationary mode)


@pytest.mark.slow
def test_physical_mode_samples_boltzmann_equilibrium():
    boltzmann_gate(**BOLTZMANN_FULL)


@pytest.mark.slow
def test_physical_mode_switching_rate_matches_neel_brown():
    for gate in NEEL_BROWN_FULL:
        neel_brown_gate(**gate)


# --- always-on scaled variants (round-4 verdict #9) ------------------------
# The full-size tests above are `slow`-marked and deselected from the
# default run, but the ROADMAP names this physics gate as the approval bar
# for any sampler change — so the default suite must exercise it too.
# Same physics, same machinery, smaller ensembles / coarser dt / wider
# statistical gates (fixed seeds; gate margins >=4x the observed spread).


def test_boltzmann_equilibrium_fast():
    """Scaled equilibrium gate: B=1024, dt=4e-13, 1.5 ns — wide KS and
    second-moment gates that would still catch a wrong sigma formula (a
    missing (1+alpha^2) or a 2x variance error shifts <m_z^2> by >>0.05)."""
    boltzmann_gate(delta=1.5, alpha=0.3, dt=4e-13, span=1.5e-9, B=1024,
                   seed=11, n_grid=2001, ks_min=1e-5, m2_tol=0.05)


def test_neel_brown_switching_rate_fast():
    """Scaled switching-rate gate: one barrier height, B=512, 6 chunks;
    the [0.4, 2.5] ratio gate is wide but still pins the exp(-Delta)
    escape physics (a wrong sigma changes the rate by e^Delta-level
    factors)."""
    neel_brown_gate(alpha=0.5, dt=4e-13, B=512, sigma=1.5, n_fp=400,
                    per_tau=10.0, chunks=6, seed=21, min_points=3, lo=0.4, hi=2.5)
