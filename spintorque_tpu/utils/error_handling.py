"""Exception hierarchy, retry decorator and safe math.

Counterpart of spin_torque_gym/utils/error_handling.py (:19-538). The
jitted hot path cannot raise; numerical robustness there is by construction
(PulseResult.failed, normalize_with_fallback). These utilities serve
host-side setup and IO code, preserving the reference's exception taxonomy
so downstream except-clauses port over unchanged.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Any, Callable, Optional, Tuple, Type

import numpy as np

logger = logging.getLogger("spintorque_tpu")


class SpinTorqueError(Exception):
    """Base error (error_handling.py:19)."""


class PhysicsError(SpinTorqueError):
    pass


class DeviceError(SpinTorqueError):
    pass


class EnvironmentError_(SpinTorqueError):
    pass


class ValidationError(SpinTorqueError):
    pass


class NumericalError(SpinTorqueError):
    pass


class ConfigurationError(SpinTorqueError):
    pass


def robust_computation(
    max_retries: int = 3,
    backoff: float = 0.1,
    exceptions: Tuple[Type[Exception], ...] = (Exception,),
    fallback: Optional[Callable[..., Any]] = None,
):
    """Retry decorator (error_handling.py:59-130)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last = None
            for attempt in range(max_retries + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:  # noqa: PERF203
                    last = e
                    if attempt < max_retries:
                        logger.warning(
                            "%s failed (attempt %d/%d): %s",
                            fn.__name__, attempt + 1, max_retries, e,
                        )
                        time.sleep(backoff * (2**attempt))
            if fallback is not None:
                return fallback(*args, **kwargs)
            raise last

        return wrapper

    return decorator


def safe_execute(fn: Callable, *args, default: Any = None, **kwargs):
    """Run fn, returning ``default`` on exception (error_handling.py:487)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001
        logger.warning("safe_execute(%s) failed: %s", getattr(fn, "__name__", fn), e)
        return default


# ---- safe math (error_handling.py:234-364); numpy/jax-array polymorphic ----

def safe_division(a, b, default: float = 0.0):
    b_arr = np.asarray(b)
    out = np.divide(a, np.where(b_arr == 0, 1.0, b_arr))
    return np.where(b_arr == 0, default, out)


def safe_sqrt(x, default: float = 0.0):
    arr = np.asarray(x, dtype=float)
    return np.where(arr >= 0, np.sqrt(np.abs(arr)), default)


def safe_log(x, default: float = 0.0):
    arr = np.asarray(x, dtype=float)
    return np.where(arr > 0, np.log(np.where(arr > 0, arr, 1.0)), default)


def safe_normalize(v, fallback=(0.0, 0.0, 1.0)):
    arr = np.asarray(v, dtype=float)
    norm = np.linalg.norm(arr, axis=-1, keepdims=True)
    ok = (norm >= 1e-12) & np.isfinite(norm)
    out = np.where(ok, arr / np.where(ok, norm, 1.0), np.asarray(fallback))
    return out


class ErrorRecoveryManager:
    """Tracks failures per context, escalating after repeated errors
    (error_handling.py:366-441)."""

    def __init__(self, max_failures: int = 5, window_s: float = 300.0):
        self.max_failures = max_failures
        self.window_s = window_s
        self._failures: dict[str, list[float]] = {}

    def record_failure(self, context: str) -> None:
        now = time.time()
        lst = self._failures.setdefault(context, [])
        lst.append(now)
        self._failures[context] = [t for t in lst if now - t < self.window_s]

    def should_abort(self, context: str) -> bool:
        return len(self._failures.get(context, [])) >= self.max_failures

    def reset(self, context: Optional[str] = None) -> None:
        if context is None:
            self._failures.clear()
        else:
            self._failures.pop(context, None)
