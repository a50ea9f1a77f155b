"""Benchmark and validation harness.

Counterpart of the reference's benchmark/validation tier
(quantum/benchmarking.py, research/validation_framework.py,
research/comparative_algorithms.py - SURVEY.md section 2.8), rebuilt as a
reproducible measurement harness over the real on-device engine: standardized
scenario suite, statistics with bootstrap confidence intervals, baseline
policy comparisons, and JSON report output.
"""

from __future__ import annotations

import json
import platform
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class BenchmarkResult:
    name: str
    value: float
    unit: str
    std: float = 0.0
    ci95: tuple = (0.0, 0.0)
    extra: Dict[str, Any] = field(default_factory=dict)


def bootstrap_ci(samples: np.ndarray, n_boot: int = 1000, seed: int = 0):
    """95% bootstrap CI of the mean."""
    rng = np.random.default_rng(seed)
    samples = np.asarray(samples, float)
    means = rng.choice(samples, size=(n_boot, samples.size), replace=True).mean(1)
    return float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5))


def significance_test(a, b) -> Dict[str, float]:
    """Welch's t-test (the statistics the reference's publication framework
    reports, research/publication_framework.py:163-315)."""
    from scipy import stats

    t, p = stats.ttest_ind(np.asarray(a, float), np.asarray(b, float),
                           equal_var=False)
    pooled = np.sqrt((np.var(a, ddof=1) + np.var(b, ddof=1)) / 2)
    cohens_d = (np.mean(a) - np.mean(b)) / pooled if pooled > 0 else 0.0
    return {"t_statistic": float(t), "p_value": float(p),
            "cohens_d": float(cohens_d)}


class BenchmarkSuite:
    """Registry of benchmark scenarios producing a JSON report."""

    def __init__(self, name: str = "spintorque_tpu"):
        self.name = name
        self._scenarios: Dict[str, Callable[[], BenchmarkResult]] = {}

    def register(self, name: str, fn: Callable[[], BenchmarkResult]) -> None:
        self._scenarios[name] = fn

    def run(self, names: Optional[List[str]] = None) -> Dict[str, Any]:
        selected = names or list(self._scenarios)
        results = {}
        for n in selected:
            t0 = time.perf_counter()
            res = self._scenarios[n]()
            res.extra["wall_s"] = round(time.perf_counter() - t0, 3)
            results[n] = asdict(res)
        return {
            "suite": self.name,
            "backend": jax.default_backend(),
            "devices": jax.device_count(),
            "platform": platform.platform(),
            "results": results,
        }

    def run_and_save(self, path: str | Path, **kwargs) -> Dict[str, Any]:
        report = self.run(**kwargs)
        Path(path).write_text(json.dumps(report, indent=2))
        return report


def _throughput_scenario(batch_size: int, thermal: bool, steps: int = 32):
    def run() -> BenchmarkResult:
        from ..envs import SpinTorqueEnv, SpinTorqueEnvConfig
        from ..parallel import random_policy

        env = SpinTorqueEnv(
            batch_size=batch_size,
            config=SpinTorqueEnvConfig(include_thermal=thermal, dtype="float32"),
        )
        policy = random_policy(env)
        key = jax.random.PRNGKey(0)
        state, obs = env.reset(key)

        @jax.jit
        def loop(state, obs, key):
            def body(c, k):
                s, o = c
                s, ts = env._step_impl(s, policy(None, o, k))
                return (s, ts.obs), None
            (state, obs), _ = jax.lax.scan(
                body, (state, obs), jax.random.split(key, steps), unroll=2
            )
            return state, obs

        state, obs = loop(state, obs, key)
        jax.block_until_ready(obs)
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            state, obs = loop(state, obs, jax.random.fold_in(key, i))
            jax.block_until_ready(obs)
            times.append(steps * batch_size / (time.perf_counter() - t0))
        arr = np.asarray(times)
        return BenchmarkResult(
            name=f"env_steps_per_s_B{batch_size}_thermal={thermal}",
            value=float(arr.mean()),
            unit="env-steps/s",
            std=float(arr.std()),
            ci95=bootstrap_ci(arr),
        )

    return run


def _solver_scenario(batch_size: int = 4096, substeps: int = 1000):
    def run() -> BenchmarkResult:
        from ..physics import IntegratorConfig, integrate_pulse
        from ..physics.solver import params_from_dict

        p = params_from_dict(
            dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
                 uniaxial_anisotropy=1.2e6, polarization=0.7,
                 easy_axis=np.array([0.0, 0.0, 1.0]))
        )
        key = jax.random.PRNGKey(0)
        m = jax.random.normal(key, (batch_size, 3), jnp.float32)
        m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
        spans = jnp.full((batch_size,), substeps * 1e-12, jnp.float32)
        cur = jnp.full((batch_size,), 1e2, jnp.float32)
        cfg = IntegratorConfig(method="rk4", max_substeps=substeps + 16)
        f = jax.jit(
            lambda m0: integrate_pulse(m0, spans, cur, p, cfg)
        )
        m0 = (m[:, 0], m[:, 1], m[:, 2])
        r = f(m0)
        jax.block_until_ready(r.m)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = f(m0)
            jax.block_until_ready(r.m)
            times.append(batch_size / (time.perf_counter() - t0))
        arr = np.asarray(times)
        return BenchmarkResult(
            name=f"solver_pulses_per_s_B{batch_size}_{substeps}substeps",
            value=float(arr.mean()),
            unit="pulses/s",
            std=float(arr.std()),
            ci95=bootstrap_ci(arr),
        )

    return run


def create_standard_benchmark_suite() -> BenchmarkSuite:
    """Standard suite (counterpart of
    quantum/benchmarking.py create_standard_benchmark_suite)."""
    suite = BenchmarkSuite()
    suite.register("solver_4096x1000", _solver_scenario(4096, 1000))
    suite.register("env_4096_thermal", _throughput_scenario(4096, True))
    suite.register("env_4096_det", _throughput_scenario(4096, False))
    return suite


def compare_policies(
    env,
    policies: Dict[str, Callable],
    horizon: int = 100,
    seed: int = 0,
) -> Dict[str, Any]:
    """Run several policies on identical env resets and report per-policy
    return statistics + pairwise significance (the capability of
    research/comparative_algorithms.py:334-800)."""
    from ..parallel import rollout_jit, summarize

    out: Dict[str, Any] = {"policies": {}}
    returns: Dict[str, np.ndarray] = {}
    for name, policy in policies.items():
        run = rollout_jit(env, policy, horizon)
        state, obs = env.reset(jax.random.PRNGKey(seed))
        state, obs, traj = run(None, state, obs, jax.random.PRNGKey(seed + 1))
        ep_returns = np.asarray(traj.info["episode_return"])[-1]
        returns[name] = ep_returns
        stats = {k: float(np.asarray(v)) for k, v in summarize(traj).items()}
        stats["mean_return"] = float(ep_returns.mean())
        out["policies"][name] = stats
    names = list(policies)
    out["significance"] = {
        f"{a}_vs_{b}": significance_test(returns[a], returns[b])
        for i, a in enumerate(names)
        for b in names[i + 1 :]
    }
    return out
