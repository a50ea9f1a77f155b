"""Device-parameter and pulse-protocol optimization on batched physics.

Honest counterpart of the reference's "quantum-inspired" optimizer tier
(spin_torque_gym/quantum/optimization.py, research/novel_algorithms.py,
research/quantum_spintronics.py - all of which are classical NumPy searches
under quantum naming; SURVEY.md section 2.8). Here the same capabilities -
optimizing device parameters or switching protocols against a simulated
objective - are implemented as classical population methods whose *entire
population evaluates in one vmapped physics call*: a 4096-candidate
generation costs one fused device step.

Provided:
  * grid_search        - exhaustive vmapped sweep
  * cross_entropy      - CEM over continuous parameters
  * simulated_annealing - batched parallel-tempering-style annealing
  * optimize_switching_pulse - find (J, dt) pulse minimizing energy subject
    to switching, the reference's canonical demo objective
    (quantum/optimization.py:34-47 equivalent)
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics import IntegratorConfig, LLGSParams, integrate_pulse


class OptimizationResult(NamedTuple):
    """Mirrors the reference result object surface
    (quantum/optimization.py:34-47)."""

    best_params: Dict[str, float]
    best_value: float
    history: np.ndarray  # per-iteration best objective
    n_evaluations: int
    method: str


def _evaluate_batch(objective, param_dict):
    return objective(param_dict)


def grid_search(
    objective: Callable[[Dict[str, jnp.ndarray]], jnp.ndarray],
    space: Dict[str, Tuple[float, float]],
    points_per_dim: int = 16,
) -> OptimizationResult:
    """Exhaustive sweep: the full cartesian grid evaluates in ONE call."""
    names = list(space)
    axes = [jnp.linspace(lo, hi, points_per_dim) for lo, hi in space.values()]
    mesh = jnp.meshgrid(*axes, indexing="ij")
    flat = {n: g.reshape(-1) for n, g in zip(names, mesh)}
    values = _evaluate_batch(objective, flat)
    idx = int(jnp.argmin(values))
    best = {n: float(flat[n][idx]) for n in names}
    return OptimizationResult(
        best_params=best,
        best_value=float(values[idx]),
        history=np.asarray([float(values[idx])]),
        n_evaluations=int(values.shape[0]),
        method="grid_search",
    )


def cross_entropy(
    objective: Callable[[Dict[str, jnp.ndarray]], jnp.ndarray],
    space: Dict[str, Tuple[float, float]],
    population: int = 1024,
    elites: int = 64,
    iterations: int = 20,
    seed: int = 0,
    smoothing: float = 0.5,
) -> OptimizationResult:
    """Cross-entropy method; one vmapped objective call per generation."""
    names = list(space)
    lo = jnp.asarray([space[n][0] for n in names])
    hi = jnp.asarray([space[n][1] for n in names])
    mean = (lo + hi) / 2.0
    std = (hi - lo) / 2.0
    key = jax.random.PRNGKey(seed)
    history = []
    best_val, best_x = jnp.inf, mean

    for _ in range(iterations):
        key, sub = jax.random.split(key)
        samples = mean + std * jax.random.normal(sub, (population, len(names)))
        samples = jnp.clip(samples, lo, hi)
        values = _evaluate_batch(
            objective, {n: samples[:, i] for i, n in enumerate(names)}
        )
        order = jnp.argsort(values)
        elite = samples[order[:elites]]
        gen_best = values[order[0]]
        better = gen_best < best_val
        best_val = jnp.where(better, gen_best, best_val)
        best_x = jnp.where(better, samples[order[0]], best_x)
        mean = smoothing * elite.mean(0) + (1 - smoothing) * mean
        std = smoothing * elite.std(0) + (1 - smoothing) * std + 1e-12
        history.append(float(gen_best))

    return OptimizationResult(
        best_params={n: float(best_x[i]) for i, n in enumerate(names)},
        best_value=float(best_val),
        history=np.asarray(history),
        n_evaluations=population * iterations,
        method="cross_entropy",
    )


def simulated_annealing(
    objective: Callable[[Dict[str, jnp.ndarray]], jnp.ndarray],
    space: Dict[str, Tuple[float, float]],
    chains: int = 256,
    iterations: int = 100,
    t_start: float = 1.0,
    t_end: float = 1e-3,
    seed: int = 0,
) -> OptimizationResult:
    """Batched annealing: ``chains`` independent walkers advance in lockstep
    (the honest version of research/quantum_spintronics.py's
    'quantum annealing', which is this algorithm under another name)."""
    names = list(space)
    lo = jnp.asarray([space[n][0] for n in names])
    hi = jnp.asarray([space[n][1] for n in names])
    span = hi - lo
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    x = lo + span * jax.random.uniform(k0, (chains, len(names)))
    v = _evaluate_batch(objective, {n: x[:, i] for i, n in enumerate(names)})

    temps = jnp.geomspace(t_start, t_end, iterations)
    history = []
    for t in temps:
        key, k1, k2 = jax.random.split(key, 3)
        prop = jnp.clip(
            x + 0.1 * span * jax.random.normal(k1, x.shape), lo, hi
        )
        pv = _evaluate_batch(objective, {n: prop[:, i] for i, n in enumerate(names)})
        accept = (pv < v) | (
            jax.random.uniform(k2, v.shape) < jnp.exp(-(pv - v) / t)
        )
        x = jnp.where(accept[:, None], prop, x)
        v = jnp.where(accept, pv, v)
        history.append(float(v.min()))

    idx = int(jnp.argmin(v))
    return OptimizationResult(
        best_params={n: float(x[idx, i]) for i, n in enumerate(names)},
        best_value=float(v[idx]),
        history=np.asarray(history),
        n_evaluations=chains * (iterations + 1),
        method="simulated_annealing",
    )


def switching_objective(
    base_params: LLGSParams,
    m_initial: Sequence[float] = (0.1, 0.0, 0.995),
    target: Sequence[float] = (0.0, 0.0, -1.0),
    energy_weight: float = 0.1,
    resistance: float = 1e3,
    area: float = 5e-15,
    config: Optional[IntegratorConfig] = None,
) -> Callable[[Dict[str, jnp.ndarray]], jnp.ndarray]:
    """Objective over (current, duration) pulses: miss distance to the
    target plus an energy penalty - the reference's canonical switching
    optimization task, evaluated by the real batched integrator."""
    cfg = config or IntegratorConfig(method="rk4", max_substeps=2048)
    m0 = np.asarray(m_initial, np.float32)
    m0 = m0 / np.linalg.norm(m0)
    tgt = np.asarray(target, np.float32)
    tgt = tgt / np.linalg.norm(tgt)

    @jax.jit
    def objective(params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        current = jnp.asarray(params["current"], jnp.float32)
        duration = jnp.clip(jnp.asarray(params["duration"], jnp.float32), 1e-12, None)
        B = current.shape[0]
        mx = jnp.full((B,), m0[0])
        my = jnp.full((B,), m0[1])
        mz = jnp.full((B,), m0[2])
        res = integrate_pulse((mx, my, mz), duration, current, base_params, cfg)
        align = res.m[0] * tgt[0] + res.m[1] * tgt[1] + res.m[2] * tgt[2]
        energy = current**2 * area**2 * resistance * duration
        return (1.0 - align) + energy_weight * energy / 1e-12

    return objective


def optimize_switching_pulse(
    base_params: LLGSParams,
    method: str = "cross_entropy",
    max_current: float = 2e6,
    max_duration: float = 2e-9,
    **kwargs,
) -> OptimizationResult:
    objective = switching_objective(base_params)
    space = {"current": (-max_current, max_current), "duration": (1e-11, max_duration)}
    if method == "grid_search":
        return grid_search(objective, space, **kwargs)
    if method == "simulated_annealing":
        return simulated_annealing(objective, space, **kwargs)
    return cross_entropy(objective, space, **kwargs)
