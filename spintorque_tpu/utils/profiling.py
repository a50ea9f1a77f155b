"""Performance profiling: named host timers + XLA device traces.

Counterpart of the reference PerformanceProfiler
(spin_torque_gym/utils/performance.py:391-498) plus what the reference
lacks: real device-side profiling via jax.profiler (SURVEY.md section 5).
The reference's AdaptiveCache/ComputationOptimizer memoization tier has no
analog here - XLA compilation caching and jit replace it wholesale.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict

import numpy as np


class PerformanceProfiler:
    """Named wall-clock timers and counters (performance.py:391-498)."""

    def __init__(self):
        self._times: Dict[str, list] = defaultdict(list)
        self._counters: Dict[str, int] = defaultdict(int)
        self._active: Dict[str, float] = {}

    def start_timer(self, name: str) -> None:
        self._active[name] = time.perf_counter()

    def end_timer(self, name: str) -> float:
        start = self._active.pop(name, None)
        if start is None:
            return 0.0
        elapsed = time.perf_counter() - start
        self._times[name].append(elapsed)
        return elapsed

    @contextlib.contextmanager
    def time_operation(self, name: str):
        self.start_timer(name)
        try:
            yield
        finally:
            self.end_timer(name)

    def increment_counter(self, name: str, amount: int = 1) -> None:
        self._counters[name] += amount

    def get_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": dict(self._counters), "timers": {}}
        for name, samples in self._times.items():
            arr = np.asarray(samples)
            out["timers"][name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "max_s": float(arr.max()),
            }
        return out

    def reset(self) -> None:
        self._times.clear()
        self._counters.clear()
        self._active.clear()


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/spintorque_trace",
                 host_tracer_level: int = 2):
    """Capture an XLA device trace viewable in TensorBoard/Perfetto.

    Usage:
        with device_trace("/tmp/trace"):
            state, ts = env.step(state, action)
            jax.block_until_ready(ts.reward)
    """
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def block_and_time(fn, *args, iters: int = 10, warmup: int = 1, **kwargs):
    """Measure steady-state wall clock of a jitted callable."""
    import jax

    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out
