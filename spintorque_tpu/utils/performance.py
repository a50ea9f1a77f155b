"""Computation optimization helpers: memoization, padding, compile stats.

Counterpart of the reference's utils/performance.py (505 LoC:
``AdaptiveCache`` :28, ``ComputationOptimizer`` :231, ``PerformanceProfiler``
:391, process-global ``get_optimizer`` :500-505). The profiler lives in
utils/profiling.py and the cache stack in utils/cache.py; this module keeps
the reference's ``ComputationOptimizer``/``get_optimizer`` surface with the
optimizations that are real on the accelerator:

  * host-side memoization via the shared cache stack (the reference's
    sin/cos lookup tables are pointless next to the device's transcendentals);
  * batch padding to warp multiples (32: the GPU pulse kernel's env block);
  * a process-wide registry of jitted functions with compile/call counters,
    replacing the reference's hand-rolled "JIT" flags with the real thing.
"""

from __future__ import annotations

import threading
import time
from functools import wraps
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .cache import AdaptiveCache, LRUCache

__all__ = ["ComputationOptimizer", "get_optimizer", "pad_batch", "unpad_batch"]

LANE = 32  # warp width = the GPU pulse kernel's env block; pad to multiples


def device_memory_bytes(device=None) -> float:
    """The device's memory limit (``memory_stats()['bytes_limit']``).

    Raises where the backend reports none (the CPU): pass the size."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError("the device reports no memory limit; pass hbm_bytes")
    return float(stats["bytes_limit"])


def pad_batch(x: np.ndarray, multiple: int = LANE) -> Tuple[np.ndarray, int]:
    """Pad axis 0 up to a multiple; returns (padded, original_size)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, mode="edge"), n


def unpad_batch(x: np.ndarray, original_size: int) -> np.ndarray:
    return x[:original_size]


class ComputationOptimizer:
    """Memoization + padding + jit registry (reference surface kept)."""

    def __init__(self, cache_size: int = 4096, ttl_s: Optional[float] = 300.0):
        self.cache = AdaptiveCache(max_size=cache_size, ttl_s=ttl_s)
        self._jitted: Dict[str, Callable] = {}
        self._counters: Dict[str, Dict[str, float]] = {}
        self._lock = threading.RLock()

    # -- memoization (host-side only) ---------------------------------------
    @staticmethod
    def hash_parameters(params: Dict[str, Any]) -> str:
        """Collision-safe parameter hash (full structure, not rounded values
        - the reference's rounding produced stale-result bugs)."""
        return LRUCache.make_key(params)

    def memoized(self, fn: Callable) -> Callable:
        sentinel = object()

        @wraps(fn)
        def wrapper(*args, **kwargs):
            key = LRUCache.make_key(fn.__qualname__, *args, **kwargs)
            out = self.cache.get(key, sentinel)
            if out is sentinel:
                out = fn(*args, **kwargs)
                self.cache.put(key, out)
            return out

        return wrapper

    def cached_computation(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        """Reference-style call-through memoization."""
        sentinel = object()
        key = LRUCache.make_key(name, *args, **kwargs)
        out = self.cache.get(key, sentinel)
        if out is sentinel:
            out = fn(*args, **kwargs)
            self.cache.put(key, out)
        return out

    # -- jit registry --------------------------------------------------------
    def jit(self, name: str, fn: Callable, **jit_kwargs) -> Callable:
        """Register a jitted function once; repeated calls reuse it and
        count invocations + cache-miss compiles."""
        with self._lock:
            if name not in self._jitted:
                import jax

                compiled = jax.jit(fn, **jit_kwargs)
                self._counters[name] = {"calls": 0, "first_call_s": 0.0}

                @wraps(fn)
                def counted(*args, **kwargs):
                    t0 = time.perf_counter()
                    out = compiled(*args, **kwargs)
                    el = time.perf_counter() - t0
                    c = self._counters[name]
                    if c["calls"] == 0:
                        c["first_call_s"] = el  # includes compile
                    c["calls"] += 1
                    return out

                self._jitted[name] = counted
            return self._jitted[name]

    # -- batch helpers -------------------------------------------------------
    def optimize_batch_size(self, item_bytes: int, hbm_bytes: Optional[float] = None,
                            reserve: float = 0.25) -> int:
        """Largest lane-aligned batch fitting the device-memory budget
        (``hbm_bytes`` defaults to the device's own limit)."""
        if hbm_bytes is None:
            hbm_bytes = device_memory_bytes()
        usable = hbm_bytes * (1.0 - reserve)
        raw = int(usable / max(item_bytes, 1))
        return max(LANE, (raw // LANE) * LANE)

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache": self.cache.stats.as_dict(),
                "cache_size": len(self.cache),
                "jitted_functions": {k: dict(v) for k, v in self._counters.items()},
            }


_optimizer: Optional[ComputationOptimizer] = None
_optimizer_lock = threading.Lock()


def get_optimizer() -> ComputationOptimizer:
    """Process-global optimizer (reference utils/performance.py:500-505)."""
    global _optimizer
    with _optimizer_lock:
        if _optimizer is None:
            _optimizer = ComputationOptimizer()
        return _optimizer
