"""Comparative baselines for switching-protocol control.

Counterpart of the reference's research/comparative_algorithms.py (800 LoC:
``OptimalControlBaseline`` :49, ``PhysicsInformedRL`` :127,
``ComparativeAnalysis`` :334, ``run_comprehensive_benchmark`` :761). The
reference's "optimal control" baseline does random shooting in NumPy; here it
is real GRAPE-style optimal control: the piecewise-constant current protocol
is optimized by Adam with gradients differentiated THROUGH the batched LLGS
integrator (jax.grad through the scan - the adjoint method for free), with
all random restarts advanced in one vmapped program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.integrator import (
    IntegratorConfig,
    integrate_pulse,
    integrate_pulse_trajectory,
)
from ..physics.llgs import LLGSParams
from .benchmarking import bootstrap_ci, significance_test

__all__ = [
    "OptimalControlBaseline",
    "PhysicsInformedRL",
    "ComparativeAnalysis",
    "run_comprehensive_benchmark",
]


class OptimalControlBaseline:
    """GRAPE-style gradient optimal control of segmented current protocols.

    The protocol is ``n_segments`` piecewise-constant current densities of
    equal duration; the loss is miss-distance to the target orientation plus
    an energy penalty (the reference's objective shape,
    comparative_algorithms.py:49-126). ``n_restarts`` protocols optimize
    simultaneously: parameters have a leading vmap axis, every Adam step is
    one fused device program integrating n_restarts full protocols.
    """

    def __init__(
        self,
        params: LLGSParams,
        n_segments: int = 4,
        segment_duration: float = 2.5e-10,
        max_current: Optional[float] = None,
        energy_weight: float = 0.1,
        resistance: float = 1e3,
        area: float = 5e-15,
        method: str = "rk4",
        max_substeps: int = 512,
    ):
        self.params = params
        self.n_segments = n_segments
        self.segment_duration = segment_duration
        if max_current is None:
            # The reference's simplified STT coefficient P*J/(Ms*V)
            # (simple_solver.py:324-342) is astronomically stiff at env-scale
            # currents (J ~ 1e6 -> coeff ~ 1e22/s: dynamics snap to the poles
            # and gradients vanish/NaN). Gradient-based control needs the
            # smooth regime, so default the bound to the current whose torque
            # rate matches the anisotropy precession rate gamma*H_k.
            from ..constants import GAMMA, MU0

            ms = float(np.asarray(params.saturation_magnetization).ravel()[0])
            ku = float(np.asarray(params.uniaxial_anisotropy).ravel()[0])
            vol = float(np.asarray(params.volume).ravel()[0])
            pol = float(np.asarray(params.polarization).ravel()[0])
            h_k = 2.0 * ku / (MU0 * ms)
            max_current = 2.0 * GAMMA * h_k * ms * vol / max(pol, 1e-3)
        self.max_current = max_current
        self.energy_weight = energy_weight
        self.resistance = resistance
        self.area = area
        self.config = IntegratorConfig(method=method, max_substeps=max_substeps)

    def _propagate(self, currents: jnp.ndarray, m0: jnp.ndarray) -> jnp.ndarray:
        """Run one protocol: currents (n_segments,), m0 (3,) -> final m (3,).

        Uses the scan-based trajectory integrator (fixed trip count), which
        is reverse-mode differentiable - jax.grad through it IS the adjoint
        method; the while_loop fast path is not differentiable.
        """
        span = jnp.asarray([self.segment_duration], jnp.float32)

        def seg(m, J):
            res, _ = integrate_pulse_trajectory(
                (m[0:1], m[1:2], m[2:3]), span, J[None], self.params, self.config
            )
            return jnp.stack([res.m[0][0], res.m[1][0], res.m[2][0]]), None

        m_final, _ = jax.lax.scan(seg, jnp.asarray(m0, jnp.float32), currents)
        return m_final

    def loss(self, currents: jnp.ndarray, m0, target) -> jnp.ndarray:
        """Miss distance + NORMALIZED drive energy.

        The energy term uses sum((J/J_max)^2)/n_segments so its gradient is
        meaningful at any current scale: switching success is nearly binary
        in this bistable physics, and the continuous signal GRAPE descends
        is "keep the switch, shrink the drive"."""
        m = self._propagate(currents, m0)
        align = jnp.dot(m, jnp.asarray(target, jnp.float32))
        energy_norm = jnp.mean((currents / self.max_current) ** 2)
        return (1.0 - align) + self.energy_weight * energy_norm

    def pulse_energy_joules(self, currents: np.ndarray) -> float:
        """Physical dissipation E = sum J^2 A^2 R dt (the env's formula,
        spin_torque_env.py:473-480)."""
        return float(
            np.sum(np.asarray(currents) ** 2) * self.area**2 * self.resistance
            * self.segment_duration
        )

    def optimize(
        self,
        m_initial: Sequence[float] = (0.1, 0.0, 0.995),
        target: Sequence[float] = (0.0, 0.0, -1.0),
        n_restarts: int = 32,
        iterations: int = 150,
        learning_rate: float = 0.1,
        seed: int = 0,
    ) -> Dict[str, Any]:
        m0 = np.asarray(m_initial, np.float32)
        m0 = m0 / np.linalg.norm(m0)
        tgt = np.asarray(target, np.float32)
        tgt = tgt / np.linalg.norm(tgt)
        key = jax.random.PRNGKey(seed)
        # parameterize currents as max_current * tanh(theta): bound-respecting
        theta0 = 0.5 * jax.random.normal(key, (n_restarts, self.n_segments))

        def restart_loss(theta):
            currents = self.max_current * jnp.tanh(theta)
            return self.loss(currents, m0, tgt)

        lr = learning_rate

        @jax.jit
        def run(theta):
            def step(carry, t):
                th, m, v = carry
                g = jax.vmap(jax.grad(restart_loss))(th)
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                mh = m / (1 - 0.9 ** (t + 1))
                vh = v / (1 - 0.999 ** (t + 1))
                th = th - lr * mh / (jnp.sqrt(vh) + 1e-8)
                return (th, m, v), jnp.min(jax.vmap(restart_loss)(th))

            (th, _, _), history = jax.lax.scan(
                step,
                (theta, jnp.zeros_like(theta), jnp.zeros_like(theta)),
                jnp.arange(iterations, dtype=jnp.float32),
            )
            losses = jax.vmap(restart_loss)(th)
            return th, losses, history

        theta, losses, history = run(theta0)
        best = int(jnp.argmin(losses))
        currents = np.asarray(self.max_current * jnp.tanh(theta[best]))
        m_final = np.asarray(self._propagate(jnp.asarray(currents), m0))
        return {
            "currents": currents,
            "segment_duration": self.segment_duration,
            "total_duration": self.segment_duration * self.n_segments,
            "final_m": m_final,
            "alignment": float(m_final @ tgt),
            "loss": float(losses[best]),
            "loss_history": np.asarray(history),
            "energy_J": self.pulse_energy_joules(currents),
            "energy_norm": float(np.mean((currents / self.max_current) ** 2)),
            "n_evaluations": int(n_restarts * iterations),
            "method": "grape_adam",
        }


class PhysicsInformedRL:
    """Physics-informed reward shaping for the PPO trainer.

    The reference's PhysicsInformedRL (comparative_algorithms.py:127-333)
    adds hand-derived physics potentials to the reward; here the shaping
    potential is the actual normalized single-domain energy (the landscape
    the integrator uses), turned into a potential-based shaping term
    F = gamma*phi(s') - phi(s) which provably preserves the optimal policy.
    """

    def __init__(self, params: LLGSParams, gamma: float = 0.99, weight: float = 0.5):
        from ..physics.llgs import energy_density

        self.params = params
        self.gamma = gamma
        self.weight = weight
        self._energy = energy_density

    def potential(self, m: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
        """Negative normalized energy barrier toward target + alignment."""
        align = jnp.sum(m * target, axis=-1)
        e = self._energy(m[..., 0], m[..., 1], m[..., 2], self.params)
        e_scale = jnp.maximum(jnp.abs(e).max(), 1e-30)
        return align - self.weight * e / e_scale

    def shaping(self, m, m_next, target) -> jnp.ndarray:
        return self.gamma * self.potential(m_next, target) - self.potential(m, target)

    def reward_components(self) -> Dict[str, Dict[str, Any]]:
        """Composite-reward config with the shaping term added (plugs into
        rewards/components.py registry)."""
        shaper = self

        def shaping_fn(obs, action, next_obs, info):
            m, m_next = info["m_prev"], info["m"]
            target = info["target"]
            return shaper.shaping(m, m_next, target)

        return {
            "success": {"weight": 10.0, "function": "success"},
            "energy": {"weight": -0.1, "function": "energy"},
            "physics_shaping": {"weight": 1.0, "function": shaping_fn},
        }


class ComparativeAnalysis:
    """Run several controllers on the same switching tasks and compare.

    Controllers are callables ``(task) -> {'alignment', 'energy_J', ...}``;
    tasks are (m_initial, target) tuples. Statistics use Welch tests and
    bootstrap CIs from research.benchmarking.
    """

    def __init__(self, params: LLGSParams, seed: int = 0):
        self.params = params
        self.seed = seed
        self.controllers: Dict[str, Callable] = {}

    def register(self, name: str, controller: Callable) -> None:
        self.controllers[name] = controller

    def register_default_controllers(self) -> None:
        params = self.params

        def optimal_control(task):
            m0, tgt = task
            oc = OptimalControlBaseline(params, n_segments=3, iterations=60)
            out = oc.optimize(m0, tgt, n_restarts=16)
            return {"alignment": out["alignment"], "energy_J": out["energy_J"]}

        def single_pulse_grid(task):
            from .optimizers import grid_search, switching_objective

            m0, tgt = task
            j_max = OptimalControlBaseline(params, n_segments=1).max_current
            obj = switching_objective(
                params, m_initial=m0, target=tgt, energy_weight=0.0
            )
            res = grid_search(
                obj, {"current": (-j_max, j_max), "duration": (1e-11, 2e-9)},
                points_per_dim=24,
            )
            return {
                "alignment": 1.0 - res.best_value,  # energy_weight=0 -> miss
                "energy_J": res.best_params["current"] ** 2 * (5e-15) ** 2
                * 1e3 * res.best_params["duration"],
            }

        def do_nothing(task):
            m0, tgt = task
            align = float(
                np.dot(np.asarray(m0) / np.linalg.norm(m0),
                       np.asarray(tgt) / np.linalg.norm(tgt))
            )
            return {"alignment": align, "energy_J": 0.0}

        self.register("optimal_control", optimal_control)
        self.register("single_pulse_grid", single_pulse_grid)
        self.register("do_nothing", do_nothing)

    def default_tasks(self, n_tasks: int = 5) -> List[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        tasks = []
        for _ in range(n_tasks):
            m0 = np.array([0.0, 0.0, 1.0]) + 0.2 * rng.normal(size=3)
            m0 /= np.linalg.norm(m0)
            tasks.append((m0.astype(np.float32), np.array([0.0, 0.0, -1.0], np.float32)))
        return tasks

    def run(self, tasks: Optional[List] = None) -> Dict[str, Any]:
        if not self.controllers:
            self.register_default_controllers()
        tasks = tasks if tasks is not None else self.default_tasks()
        per_method: Dict[str, Dict[str, List[float]]] = {}
        for name, controller in self.controllers.items():
            rows = [controller(t) for t in tasks]
            per_method[name] = {
                k: [float(r[k]) for r in rows] for k in rows[0]
            }

        report: Dict[str, Any] = {"methods": {}, "comparisons": {}}
        for name, metrics in per_method.items():
            aligns = np.asarray(metrics["alignment"])
            report["methods"][name] = {
                "mean_alignment": float(aligns.mean()),
                "alignment_ci95": bootstrap_ci(aligns) if aligns.size > 1 else
                (float(aligns[0]), float(aligns[0])),
                "mean_energy_J": float(np.mean(metrics["energy_J"])),
                "success_rate": float(np.mean(aligns > 0.9)),
            }
        names = list(per_method)
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                xa = np.asarray(per_method[a]["alignment"])
                xb = np.asarray(per_method[b]["alignment"])
                if xa.size > 1 and xb.size > 1 and (xa.std() + xb.std()) > 0:
                    report["comparisons"][f"{a}_vs_{b}"] = significance_test(xa, xb)
        return report


def run_comprehensive_benchmark(
    params: Optional[LLGSParams] = None,
    n_tasks: int = 5,
    seed: int = 0,
) -> Dict[str, Any]:
    """One-call comparative benchmark across all default controllers
    (reference run_comprehensive_benchmark, comparative_algorithms.py:761)."""
    if params is None:
        from ..physics.solver import params_from_dict

        params = params_from_dict(
            dict(
                volume=1e-24,
                saturation_magnetization=800e3,
                damping=0.01,
                uniaxial_anisotropy=8e5,
                polarization=0.7,
                easy_axis=np.array([0.0, 0.0, 1.0]),
            )
        )
    analysis = ComparativeAnalysis(params, seed=seed)
    analysis.register_default_controllers()
    report = analysis.run(analysis.default_tasks(n_tasks))
    report["config"] = {"n_tasks": n_tasks, "seed": seed}
    return report
