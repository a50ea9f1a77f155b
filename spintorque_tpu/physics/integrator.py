"""Fixed-step batched LLGS pulse integrator.

This replaces the reference's Python-level hot loop
(spin_torque_gym/physics/simple_solver.py:136-179: ~1000 RK4 substeps per
1 ns pulse, one device at a time, ~1.8 s per env step). Here the whole batch
advances in lockstep inside a single jit-compiled ``lax.while_loop`` whose
body is one fused elementwise kernel over (B,) component arrays.

Per-env variable pulse durations are handled with a *masked* loop: every env
computes its own (dt, n_substeps) from the reference's step-size law
(simple_solver.py:136-139)

    dt0 = min(max_step, span / 100)
    n   = max(10, int(span / dt0))
    dt  = span / n

and envs whose n is below the running index simply hold their state. The loop
runs to max(n) over the batch (dynamic trip count), so a batch of short pulses
pays only for its longest member, bounded by ``max_substeps``.

Thermal noise modes:
  * 'reference' - per-field-evaluation white field with Brown's sigma and NO
    1/sqrt(dt) scaling, replicating simple_solver.py:377-384 (including its
    physical inconsistency), but driven by counter-based threefry keys
    (reproducible streams) instead of the reference's unseeded global
    np.random (simple_solver.py:384 - a reproducibility bug we fix).
  * 'physical' - the correct sqrt(2 alpha k_B T / (gamma mu0 Ms V dt))
    white-field discretization of Brown's model (thermal_model.py:67-73),
    best paired with method='heun' (Stratonovich-consistent).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import GAMMA, KB_SOLVER, MU0
from .llgs import LLGSParams, dmdt, normalize_with_fallback

_N_STAGES = {"euler": 1, "heun": 1, "rk4": 4}


class IntegratorConfig(NamedTuple):
    """Static (trace-time) integrator configuration."""

    method: str = "rk4"  # 'euler' | 'rk4' | 'heun'
    max_step: float = 1e-12  # reference max_step (s)
    max_substeps: int = 5120  # static upper bound on the masked loop
    thermal: bool = False
    noise_mode: str = "reference"  # 'reference' | 'physical'
    use_pallas: bool = False  # fused GPU kernel (ops/pallas_integrator)
    # RK4 thermal-field sampling:
    #   'per_stage'   - fresh iid field at every RHS evaluation, mirroring the
    #                   reference (simple_solver.py draws inside each call).
    #                   Physically this deflates the effective per-substep
    #                   noise variance to 10/36 (the squared RK4 weights),
    #                   since the four iid draws average.
    #   'per_substep' - ONE field realization held constant across the four
    #                   stages (the standard SDE treatment; stochastic Heun
    #                   already works this way) - and 4x less sampling work.
    rk4_noise: str = "per_stage"


def max_substeps_for(max_duration: float, max_step: float = 1e-12) -> int:
    """Static substep bound for pulses up to ``max_duration`` under the
    reference dt law."""
    return max(10, int(math.ceil(max_duration / min(max_step, max_duration / 100.0))) + 1)


def substep_counts(span: jnp.ndarray, max_step: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-env (dt, n_substeps) from the reference step-size law
    (simple_solver.py:136-139; int() truncates toward zero = floor here).

    The optimization barrier is load-bearing: XLA's algebraic simplifier
    otherwise rewrites span/(span/100) to exactly 100, while strict IEEE
    evaluation (and the reference's NumPy) can give 99.999..; n would then
    differ between compiled programs and from the reference. The barrier
    forces strict evaluation in every program, keeping n bit-stable.
    """
    dtype = jnp.result_type(span)
    # Barrier the constant so XLA cannot rewrite span/100 into span*0.01
    # (0.01 is inexact in binary; the 1-ulp difference flips n at integer
    # boundaries of the quotient).
    hundred = lax.optimization_barrier(jnp.asarray(100.0, dtype))
    dt0 = jnp.minimum(jnp.asarray(max_step, dtype), span / hundred)
    dt0 = lax.optimization_barrier(dt0)
    n = jnp.maximum(10, jnp.floor(span / dt0).astype(jnp.int32))
    dt = span / n.astype(dtype)
    return dt, n


class PulseResult(NamedTuple):
    m: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]  # final components, each (B,)
    n_substeps: jnp.ndarray  # (B,) int32
    dt: jnp.ndarray  # (B,)
    failed: jnp.ndarray  # (B,) bool - trajectory contained an all-zero row

    # Why ``failed`` exists: in the reference, an RK4 blow-up can yield a
    # step with finite components whose squared norm overflows to inf;
    # m/inf then "normalizes" to an exact zero vector which the solver's
    # validator accepts (simple_solver.py:208-229). The robust wrapper later
    # walks the trajectory, raises on the zero row (robust_solver.py:196-205
    # - and the raise escapes because validation.ValidationError is a
    # different class from the error_handling.ValidationError it catches),
    # the whole solve is discarded, and the env keeps the pre-step
    # magnetization (spin_torque_env.py:461-467). Net reference semantics:
    # such pulses FREEZE the state. We reproduce that with this flag.


def _noise_sigma(params: LLGSParams, temperature, dt, config: IntegratorConfig, dtype):
    """Thermal field amplitude per noise mode; 0 where T <= 0."""
    alpha = jnp.asarray(params.damping, dtype)
    ms = jnp.asarray(params.saturation_magnetization, dtype)
    vol = jnp.asarray(params.volume, dtype)
    temperature = jnp.asarray(temperature, dtype)
    denom = MU0 * ms * vol * GAMMA
    if config.noise_mode == "physical":
        sigma = jnp.sqrt(2.0 * alpha * KB_SOLVER * temperature / (denom * dt))
    elif config.noise_mode == "reference":
        # simple_solver.py:380-383 (no dt scaling).
        sigma = jnp.sqrt(2.0 * alpha * KB_SOLVER * temperature / denom)
    else:
        raise ValueError(f"Unknown noise_mode: {config.noise_mode}")
    return jnp.where(temperature > 0.0, sigma, 0.0)


def _stage_noise(key, i, n_stages, shape, dtype):
    """iid standard-normal draws for all RK stages of substep ``i``.

    One counter-based threefry invocation per substep covers the whole batch;
    keying on the substep index makes the stream layout-independent.
    """
    k = jax.random.fold_in(key, i)
    return jax.random.normal(k, (n_stages, 3) + shape, dtype)


def _substep(m, dt, current, params, config: IntegratorConfig, sigma, key, i):
    """One masked integration substep: advance + renormalize.

    Matches the reference stepper exactly in the deterministic case:
    Euler (simple_solver.py:263-276) / RK4 (:278-295), followed by
    validate_magnetization's normalize-with-fallback (:208-229).
    """
    mx, my, mz = m
    dtype = jnp.result_type(mx)
    shape = jnp.shape(mx)
    n_stages = _N_STAGES[config.method]

    if sigma is not None:
        if config.rk4_noise not in ("per_stage", "per_substep"):
            raise ValueError(f"Unknown rk4_noise: {config.rk4_noise}")
        n_draw = 1 if config.rk4_noise == "per_substep" else n_stages
        noise = _stage_noise(key, i, n_draw, shape, dtype)
        stage = [
            (sigma * noise[d, 0], sigma * noise[d, 1], sigma * noise[d, 2])
            for d in (min(s, n_draw - 1) for s in range(n_stages))
        ]
    else:
        stage = [(0.0, 0.0, 0.0)] * n_stages

    def rhs(ax, ay, az, s):
        return dmdt(ax, ay, az, current, params, h_thermal=stage[s])

    if config.method == "euler":
        fx, fy, fz = rhs(mx, my, mz, 0)
        nx, ny, nz = mx + dt * fx, my + dt * fy, mz + dt * fz
    elif config.method == "heun":
        # Stochastic Heun: corrector reuses the predictor's noise realization.
        fx, fy, fz = rhs(mx, my, mz, 0)
        gx, gy, gz = rhs(mx + dt * fx, my + dt * fy, mz + dt * fz, 0)
        half = jnp.asarray(0.5, dtype)
        nx = mx + half * dt * (fx + gx)
        ny = my + half * dt * (fy + gy)
        nz = mz + half * dt * (fz + gz)
    else:  # rk4 - fresh noise per stage, as the reference draws per RHS eval
        k1x, k1y, k1z = rhs(mx, my, mz, 0)
        k1x, k1y, k1z = dt * k1x, dt * k1y, dt * k1z
        k2x, k2y, k2z = rhs(mx + k1x / 2, my + k1y / 2, mz + k1z / 2, 1)
        k2x, k2y, k2z = dt * k2x, dt * k2y, dt * k2z
        k3x, k3y, k3z = rhs(mx + k2x / 2, my + k2y / 2, mz + k2z / 2, 2)
        k3x, k3y, k3z = dt * k3x, dt * k3y, dt * k3z
        k4x, k4y, k4z = rhs(mx + k3x, my + k3y, mz + k3z, 3)
        k4x, k4y, k4z = dt * k4x, dt * k4y, dt * k4z
        nx = mx + (k1x + 2 * k2x + 2 * k3x + k4x) / 6
        ny = my + (k1y + 2 * k2y + 2 * k3y + k4y) / 6
        nz = mz + (k1z + 2 * k2z + 2 * k3z + k4z) / 6

    return normalize_with_fallback(nx, ny, nz, dtype)


def integrate_pulse(
    m0: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    span: jnp.ndarray,
    current: jnp.ndarray,
    params: LLGSParams,
    config: IntegratorConfig,
    key: Optional[jax.Array] = None,
    temperature: jnp.ndarray | float = 300.0,
    mesh=None,
    data_axis: str = "data",
) -> PulseResult:
    """Advance a batch of magnetizations through one square current pulse.

    Args:
        m0: magnetization components (mx, my, mz), each (B,) (or scalar).
        span: (B,) pulse durations (s), already clipped > 0.
        current: (B,) current densities J (A/m^2), constant over the pulse
            (the reference's square current_func, spin_torque_env.py:442-443).
        params: LLGSParams with scalar or (B,) fields.
        config: static IntegratorConfig.
        key: PRNG key (required when config.thermal).
        temperature: scalar or (B,) Kelvin.
        mesh: optional jax.sharding.Mesh when the batch is sharded over
            ``data_axis`` - makes the GPU kernel run per shard under
            shard_map (zero data collectives). The XLA path needs no mesh:
            it is elementwise and auto-partitions collective-free.
    """
    mx0, my0, mz0 = m0
    dtype = jnp.result_type(mx0)

    if config.use_pallas:
        # Fast path: a whole pulse in one kernel launch. Callers resolve
        # use_pallas at build time (ops.pallas_integrator.select_kernel).
        from ..ops.pallas_integrator import integrate_pulse_pallas

        m, n, dt, failed = integrate_pulse_pallas(
            m0, span, current, params, config._replace(use_pallas=False),
            key=key, temperature=temperature, mesh=mesh, data_axis=data_axis,
        )
        return PulseResult(m=m, n_substeps=n, dt=dt, failed=failed)

    span = jnp.asarray(span, dtype)
    current = jnp.asarray(current, dtype)

    dt, n = substep_counts(span, config.max_step)
    n = jnp.minimum(n, config.max_substeps)
    # Recompute dt from the clamped n so out-of-budget pulses integrate
    # their FULL span at coarser dt instead of silently truncating; for
    # in-range pulses span/n is bitwise the value substep_counts produced.
    dt = span / n.astype(dtype)
    n_max = jnp.max(n)

    if config.thermal:
        if key is None:
            raise ValueError("integrate_pulse: thermal=True requires a PRNG key")
        sigma = _noise_sigma(params, temperature, dt, config, dtype)
    else:
        sigma = None

    def cond(carry):
        return carry[0] < n_max

    def body(carry):
        i, mx, my, mz, failed = carry
        nx, ny, nz = _substep((mx, my, mz), dt, current, params, config, sigma, key, i)
        active = i < n
        zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        return (
            i + 1,
            jnp.where(active, nx, mx),
            jnp.where(active, ny, my),
            jnp.where(active, nz, mz),
            failed | zero_row,
        )

    failed0 = jnp.zeros(jnp.shape(mx0), bool)
    _, mx, my, mz, failed = lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), mx0, my0, mz0, failed0)
    )
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed)


def integrate_pulse_trajectory(
    m0: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    span: jnp.ndarray,
    current: jnp.ndarray,
    params: LLGSParams,
    config: IntegratorConfig,
    key: Optional[jax.Array] = None,
    temperature: jnp.ndarray | float = 300.0,
):
    """Like integrate_pulse but records the (max_substeps+1, 3, ...) state
    trajectory (fixed-length scan; inactive substeps repeat the held state).

    Returns (PulseResult, trajectory). The analog of the reference's 'm'
    trajectory array (simple_solver.py:142-144); analysis-path only.
    """
    mx0, my0, mz0 = m0
    dtype = jnp.result_type(mx0)
    span = jnp.asarray(span, dtype)
    current = jnp.asarray(current, dtype)
    dt, n = substep_counts(span, config.max_step)
    n = jnp.minimum(n, config.max_substeps)
    dt = span / n.astype(dtype)
    sigma = (
        _noise_sigma(params, temperature, dt, config, dtype) if config.thermal else None
    )
    if config.thermal and key is None:
        raise ValueError("integrate_pulse_trajectory: thermal=True requires a PRNG key")

    def step_fn(carry, i):
        mx, my, mz, failed = carry
        nx, ny, nz = _substep((mx, my, mz), dt, current, params, config, sigma, key, i)
        active = i < n
        zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        mx = jnp.where(active, nx, mx)
        my = jnp.where(active, ny, my)
        mz = jnp.where(active, nz, mz)
        return (mx, my, mz, failed | zero_row), jnp.stack([mx, my, mz])

    failed0 = jnp.zeros(jnp.shape(mx0), bool)
    (mx, my, mz, failed), traj = lax.scan(
        step_fn, (mx0, my0, mz0, failed0),
        jnp.arange(config.max_substeps, dtype=jnp.int32),
    )
    first = jnp.stack([jnp.asarray(mx0, dtype), jnp.asarray(my0, dtype), jnp.asarray(mz0, dtype)])[None]
    traj = jnp.concatenate([first, traj], axis=0)
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed), traj
