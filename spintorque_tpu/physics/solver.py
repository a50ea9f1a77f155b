"""Batched LLGS solver facades.

``LLGSSolver`` is the user-facing equivalent of the reference's solver stack
(SimpleLLGSSolver / RobustLLGSSolver / ScalableLLGSSolver / VectorizedSolver,
spin_torque_gym/physics/simple_solver.py, utils/robust_solver.py,
utils/scalable_solver.py, utils/vectorized_operations.py) collapsed into one
jit-compiled batched object. Batching *is* the scaling strategy on the accelerator, so the
reference's thread pools, retry ladders and result caches have no analog here;
robustness is provided by construction (masked loop, NaN-guarded renormalize
every substep - there is no exception path to retry).

The solve method accepts a single (3,) vector or a (B, 3) batch and returns
final magnetizations; set ``return_trajectory=True`` for the full path.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .integrator import (
    IntegratorConfig,
    integrate_pulse,
    integrate_pulse_trajectory,
)
from .llgs import LLGSParams


@partial(jax.jit, static_argnames=("config", "thermal"))
def _solve_final_jit(m, span, current, params, config: IntegratorConfig,
                     temperature, key, thermal: bool):
    """Whole-solve jitted core: one compiled program per (shape, config).

    Jitting end-to-end matters on an accelerator, where every eager op is
    its own dispatched program.
    """
    from .llgs import normalize_with_fallback

    nx, ny, nz = normalize_with_fallback(m[:, 0], m[:, 1], m[:, 2], m.dtype)
    res = integrate_pulse(
        (nx, ny, nz), span, current, params, config,
        key=key if thermal else None, temperature=temperature,
    )
    return jnp.stack(res.m, axis=-1), res.n_substeps, res.dt, res.failed


@partial(jax.jit, static_argnames=("config", "thermal"))
def _solve_traj_jit(m, span, current, params, config: IntegratorConfig,
                    temperature, key, thermal: bool):
    from .llgs import normalize_with_fallback

    nx, ny, nz = normalize_with_fallback(m[:, 0], m[:, 1], m[:, 2], m.dtype)
    res, traj = integrate_pulse_trajectory(
        (nx, ny, nz), span, current, params, config,
        key=key if thermal else None, temperature=temperature,
    )
    return jnp.transpose(traj, (2, 0, 1)), res.n_substeps, res.dt, res.failed

_DEFAULTS = dict(
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1e6,
    volume=1e-24,
    polarization=0.7,
)


def params_from_dict(device_params: Dict[str, Any], dtype=jnp.float32) -> LLGSParams:
    """Build LLGSParams from a reference-style device_params dict, applying
    the same defaults the reference solver uses (simple_solver.py:310-315)."""
    easy_axis = np.asarray(device_params.get("easy_axis", np.array([0.0, 0.0, 1.0])))
    return LLGSParams(
        saturation_magnetization=jnp.asarray(
            device_params.get("saturation_magnetization", _DEFAULTS["saturation_magnetization"]), dtype
        ),
        damping=jnp.asarray(device_params.get("damping", _DEFAULTS["damping"]), dtype),
        uniaxial_anisotropy=jnp.asarray(
            device_params.get("uniaxial_anisotropy", _DEFAULTS["uniaxial_anisotropy"]), dtype
        ),
        volume=jnp.asarray(device_params.get("volume", _DEFAULTS["volume"]), dtype),
        polarization=jnp.asarray(device_params.get("polarization", _DEFAULTS["polarization"]), dtype),
        easy_axis=jnp.asarray(easy_axis, dtype),
    )


def _normalized_trivial(m: np.ndarray) -> np.ndarray:
    """Zero-span result: NORMALIZED initial state with the reference's
    validate-before-span-check semantics (simple_solver.py:119-123),
    including the isfinite guard - non-finite or zero-norm inputs fall
    back to [0, 0, 1] (shared by both solver facades so the guards cannot
    drift apart; review finding: the adaptive copy had lost the isfinite
    check and returned NaN with success=True)."""
    norm = np.linalg.norm(m, axis=-1, keepdims=True)
    ok = (norm >= 1e-12) & np.isfinite(norm) & np.isfinite(m).all(-1, keepdims=True)
    return np.where(ok, m / np.where(ok, norm, 1.0), np.array([0.0, 0.0, 1.0]))


class LLGSSolver:
    """Batched fixed-step LLGS solver (jit-compiled, device-resident).

    Parameters mirror the reference SimpleLLGSSolver constructor
    (simple_solver.py:24-45); rtol/atol are accepted for API compatibility
    but the fixed-step methods do not use them (same as the reference).
    """

    def __init__(
        self,
        method: str = "euler",  # reference default (simple_solver.py:28)
        rtol: float = 1e-3,
        atol: float = 1e-6,
        max_step: float = 1e-12,
        max_substeps: int = 5120,
        timeout: float | None = None,  # accepted for API compat; unused
        dtype=jnp.float32,
    ):
        method = method.lower()
        if method not in ("euler", "rk4", "heun"):
            method = "euler"
        self.method = method
        self.rtol = rtol
        self.atol = atol
        self.max_step = max_step
        self.max_substeps = max_substeps
        self.dtype = dtype
        self.solve_count = 0

    def _config(self, thermal: bool, noise_mode: str) -> IntegratorConfig:
        return IntegratorConfig(
            method=self.method,
            max_step=self.max_step,
            max_substeps=self.max_substeps,
            thermal=thermal,
            noise_mode=noise_mode,
        )

    def solve(
        self,
        m_initial,
        t_span,
        device_params: Dict[str, Any] | LLGSParams,
        current: float | jnp.ndarray = 0.0,
        thermal_noise: bool = False,
        temperature: float = 300.0,
        key: Optional[jax.Array] = None,
        noise_mode: str = "reference",
        return_trajectory: bool = False,
    ) -> Dict[str, Any]:
        """Solve the LLGS equation over (t_start, t_end) for one square pulse.

        m_initial: (3,) or (B, 3). Returns a dict mirroring the reference
        result surface: {'m': final (B,3) or trajectory, 'success', 'n_steps'}.
        """
        self.solve_count += 1
        m = np.asarray(m_initial, dtype=np.dtype(self.dtype))
        single = m.ndim == 1
        if single:
            m = m[None, :]
        t_start, t_end = t_span
        span = float(t_end) - float(t_start)
        if span <= 0.0:
            m_norm = _normalized_trivial(m)
            return {
                "t": jnp.asarray([t_start, t_end], self.dtype),
                "m": jnp.asarray(m_norm[0] if single else m_norm, self.dtype),
                "success": True,
                "message": "Trivial solution (zero time span)",
                "n_steps": 1,
            }
        if isinstance(device_params, LLGSParams):
            params = device_params.astype(self.dtype)
        else:
            params = params_from_dict(device_params, self.dtype)
        m = jnp.asarray(m)
        spans = jnp.full(m.shape[:1], span, self.dtype)
        currents = jnp.broadcast_to(jnp.asarray(current, self.dtype), m.shape[:1])
        cfg = self._config(thermal_noise, noise_mode)
        if key is None:
            key = jax.random.PRNGKey(0)

        if return_trajectory:
            traj, n_steps, dt, failed = _solve_traj_jit(
                m, spans, currents, params, cfg, temperature, key, thermal_noise
            )
            m_out = traj[0] if single else traj
        else:
            m_final, n_steps, dt, failed = _solve_final_jit(
                m, spans, currents, params, cfg, temperature, key, thermal_noise
            )
            m_out = m_final[0] if single else m_final

        # Per-env failure flag mirrors the reference robust wrapper's
        # discard-on-invalid-trajectory semantics (see PulseResult.failed).
        any_failed = bool(jnp.any(failed))
        return {
            "m": m_out,
            "success": not any_failed,
            "failed": failed[0] if single else failed,
            "message": (
                "Integration completed successfully"
                if not any_failed
                else "Fallback result: magnetization has zero magnitude"
            ),
            "n_steps": n_steps[0] if single else n_steps,
            "dt": dt[0] if single else dt,
        }

    def get_solver_info(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "solve_count": self.solve_count,
            "max_step": self.max_step,
            "max_substeps": self.max_substeps,
            "backend": jax.default_backend(),
        }


# Aliases mirroring the reference's public names (physics/__init__.py:10-22,
# utils/robust_solver.py:22, utils/scalable_solver.py:23). Here they are the
# same batched object: robustness and scale come from the compiled design.
SimpleLLGSSolver = LLGSSolver
RobustLLGSSolver = LLGSSolver
ScalableLLGSSolver = LLGSSolver


class AdaptiveLLGSSolver:
    """Tolerance-controlled adaptive solver facade.

    Mirrors the surface of the reference's scipy-backed adaptive solver
    class (spin_torque_gym/physics/llgs_solver.py:21-60,
    ``LLGSSolver(method='RK45', rtol=..., atol=...)`` with methods
    'RK45'/'DOP853'/'Radau'/'BDF'/'LSODA'), delegating to the batched
    accelerator-native integrators in physics/adaptive.py: the explicit names run
    the embedded Dormand-Prince RK5(4) pair, the stiff names run the
    3-stage Radau IIA (order 5, L-stable, full Newton on the batched 9-dim
    stage system; golden-tested against scipy Radau and matching its
    accepted-step counts — docs/STIFF_SOLVER_STEPS.json), and 'midpoint'
    keeps the order-2 implicit midpoint. Accepts a single (3,)
    vector or a (B, 3) batch - the whole batch adapts in lockstep with
    per-env (t, dt) bookkeeping.

    Note this solver integrates the reference's ADAPTIVE-solver RHS
    (llgs_solver_rhs: explicit Gilbert damping, demag factors, beta
    torque), which deliberately differs from the fixed-step hot-path RHS,
    exactly as the two reference solvers differ.
    """

    def __init__(
        self,
        method: str = "RK45",
        rtol: float = 1e-6,
        atol: float = 1e-9,
        max_steps: int = 100_000,
        dt_init: float = 1e-13,
        dt_min: float = 1e-16,
        dt_max: float = 1e-11,
        dtype=jnp.float32,
    ):
        from .adaptive import _EXPLICIT_METHODS, _IMPLICIT_METHODS

        if method.lower() not in _EXPLICIT_METHODS + _IMPLICIT_METHODS:
            raise ValueError(
                f"AdaptiveLLGSSolver: unknown method {method!r}; choose one "
                f"of {_EXPLICIT_METHODS + _IMPLICIT_METHODS}"
            )
        self.method = method
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.dt_init = dt_init
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.dtype = dtype
        self.solve_count = 0

    def solve(
        self,
        m_initial,
        t_span,
        device_params: Dict[str, Any] | LLGSParams,
        current: float | jnp.ndarray = 0.0,
    ) -> Dict[str, Any]:
        """Adaptive solve over (t_start, t_end); returns the reference-style
        dict {'m', 'success', 'n_steps', 'n_rejected', 'message'}."""
        from .adaptive import integrate_adaptive

        self.solve_count += 1
        m = np.asarray(m_initial, dtype=np.dtype(self.dtype))
        single = m.ndim == 1
        if single:
            m = m[None, :]
        t_start, t_end = t_span
        span = float(t_end) - float(t_start)
        if span <= 0.0:
            m_norm = _normalized_trivial(m)
            return {
                "m": jnp.asarray(m_norm[0] if single else m_norm, self.dtype),
                "success": True,
                "n_steps": 0,
                "n_rejected": 0,
                "message": "Trivial solution (zero time span)",
            }
        if isinstance(device_params, LLGSParams):
            params = device_params.astype(self.dtype)
        else:
            params = params_from_dict(device_params, self.dtype)
        m = jnp.asarray(m)
        spans = jnp.full(m.shape[:1], span, self.dtype)
        currents = jnp.broadcast_to(jnp.asarray(current, self.dtype), m.shape[:1])
        res = integrate_adaptive(
            (m[:, 0], m[:, 1], m[:, 2]), spans, currents, params,
            rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
            dt_init=self.dt_init, dt_min=self.dt_min, dt_max=self.dt_max,
            method=self.method,
        )
        m_out = jnp.stack(res.m, axis=-1)
        ok = bool(res.success.all())
        return {
            "m": m_out[0] if single else m_out,
            "success": ok,
            "n_steps": res.n_steps[0] if single else res.n_steps,
            "n_rejected": res.n_rejected[0] if single else res.n_rejected,
            "message": (
                "Adaptive integration completed"
                if ok else "max_steps reached before t_end for some envs"
            ),
        }

    def get_solver_info(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "rtol": self.rtol,
            "atol": self.atol,
            "solve_count": self.solve_count,
            "backend": jax.default_backend(),
        }
