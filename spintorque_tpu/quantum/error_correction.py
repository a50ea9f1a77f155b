"""Topological / surface-code error correction, batched on the accelerator.

Counterpart of the reference's quantum/error_correction.py (1040 LoC:
``SkyrmionErrorCorrection``, ``TopologicalProtection``,
``SurfaceCodeErrorCorrection``, ``LogicalQubitOperations``). The reference
simulates codes amplitude-by-amplitude in Python loops; here error dynamics
use the *Pauli-frame* picture: errors are binary vectors, syndrome extraction
is a GF(2) matrix-vector product (one f32 matmul + mod 2), and
Monte-Carlo trials batch along a leading axis - a million decode trials is a
(1e6, n) @ (n, s) matmul, not a loop.

Physics tie-in: ``TopologicalProtection`` maps a skyrmion device's stability
factor (devices/skyrmion_ops.py) to a physical error rate via an Arrhenius
law, and ``SkyrmionErrorCorrection`` evaluates how much a repetition /
surface code suppresses the resulting logical error rate.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import KB

__all__ = [
    "SurfaceCodeErrorCorrection",
    "SkyrmionErrorCorrection",
    "TopologicalProtection",
    "LogicalQubitOperations",
]


def _mod2_matmul(errors: jnp.ndarray, parity_t: jnp.ndarray) -> jnp.ndarray:
    """(B, n) x (n, s) GF(2) product as f32 matmul + parity extract."""
    prod = errors.astype(jnp.float32) @ parity_t.astype(jnp.float32)
    return jnp.mod(prod, 2.0).astype(jnp.int32)


class SurfaceCodeErrorCorrection:
    """Distance-3 rotated surface code under independent X/Z noise.

    9 data qubits on a 3x3 grid, 4 X- and 4 Z-stabilizers, exact
    minimum-weight lookup decoding (the optimal decoder at d=3), batched
    Monte-Carlo logical-error-rate estimation.

    Grid layout (data qubit index = 3*row + col):
        0 1 2
        3 4 5
        6 7 8
    """

    DISTANCE = 3
    N_DATA = 9

    # Rotated d=3 layout: checkerboard bulk plaquettes {0,1,3,4}/{4,5,7,8}
    # (Z) and {1,2,4,5}/{3,4,6,7} (X) plus weight-2 boundary stabilizers.
    # Every X/Z pair overlaps on an even number of qubits (CSS commutation),
    # both groups have GF(2) rank 4 -> exactly one logical qubit, and the
    # minimum-weight undetected non-stabilizer error has weight 3.
    # Z-stabilizers detect X errors.
    Z_STABILIZERS = np.array(
        [
            [1, 1, 0, 1, 1, 0, 0, 0, 0],  # {0,1,3,4}
            [0, 0, 0, 0, 1, 1, 0, 1, 1],  # {4,5,7,8}
            [0, 0, 1, 0, 0, 1, 0, 0, 0],  # {2,5}
            [0, 0, 0, 1, 0, 0, 1, 0, 0],  # {3,6}
        ],
        np.int32,
    )
    # X-stabilizers detect Z errors.
    X_STABILIZERS = np.array(
        [
            [0, 1, 1, 0, 1, 1, 0, 0, 0],  # {1,2,4,5}
            [0, 0, 0, 1, 1, 0, 1, 1, 0],  # {3,4,6,7}
            [1, 1, 0, 0, 0, 0, 0, 0, 0],  # {0,1}
            [0, 0, 0, 0, 0, 0, 0, 1, 1],  # {7,8}
        ],
        np.int32,
    )
    # Logical X spans the left column (connects X-boundaries), logical Z the
    # top row; they commute with all stabilizers and overlap on qubit 0 only.
    LOGICAL_X = np.array([1, 0, 0, 1, 0, 0, 1, 0, 0], np.int32)
    LOGICAL_Z = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0], np.int32)

    def __init__(self):
        self._decode_x = self._build_decoder(self.Z_STABILIZERS)
        self._decode_z = self._build_decoder(self.X_STABILIZERS)

    def _build_decoder(self, stabilizers: np.ndarray) -> np.ndarray:
        """Minimum-weight correction for each of the 2^s syndromes.

        Exact: enumerate all 2^9 error patterns, keep the lowest-weight
        representative per syndrome. Returns (2^s, n) int32 table.
        """
        s = stabilizers.shape[0]
        n = stabilizers.shape[1]
        table = np.full((2**s, n), -1, np.int32)
        weight = np.full((2**s,), 99, np.int32)
        for e in range(2**n):
            bits = np.array([(e >> i) & 1 for i in range(n)], np.int32)
            w = bits.sum()
            syn = (stabilizers @ bits) % 2
            key = int(np.dot(syn, 1 << np.arange(s)))
            if w < weight[key]:
                weight[key] = w
                table[key] = bits
        return table

    # -- core operations ----------------------------------------------------
    def measure_syndrome(self, errors: jnp.ndarray, kind: str = "x") -> jnp.ndarray:
        """Syndromes for a (B, 9) batch of X ('x') or Z ('z') error vectors."""
        stab = self.Z_STABILIZERS if kind == "x" else self.X_STABILIZERS
        return _mod2_matmul(errors, jnp.asarray(stab.T))

    def decode(self, syndromes: jnp.ndarray, kind: str = "x") -> jnp.ndarray:
        """Batched lookup decode: (B, 4) syndromes -> (B, 9) corrections."""
        table = jnp.asarray(self._decode_x if kind == "x" else self._decode_z)
        powers = 1 << jnp.arange(syndromes.shape[-1])
        keys = jnp.sum(syndromes * powers, axis=-1)
        return table[keys]

    def logical_failure(self, errors: jnp.ndarray, kind: str = "x") -> jnp.ndarray:
        """Whether decode(syndrome) + error anticommutes with the logical op."""
        syn = self.measure_syndrome(errors, kind)
        corr = self.decode(syn, kind)
        residual = jnp.mod(errors + corr, 2)
        logical = jnp.asarray(self.LOGICAL_Z if kind == "x" else self.LOGICAL_X)
        # residual X error flips Z_L measurement iff overlap is odd
        overlap = jnp.mod(residual @ logical, 2)
        return overlap.astype(bool)

    def logical_error_rate(
        self, physical_rate: float, n_trials: int = 100_000, seed: int = 0
    ) -> Dict[str, float]:
        """Monte-Carlo logical X and Z error rates at a physical rate p."""
        key = jax.random.PRNGKey(seed)
        kx, kz = jax.random.split(key)

        @jax.jit
        def run(kx, kz):
            ex = (
                jax.random.uniform(kx, (n_trials, self.N_DATA)) < physical_rate
            ).astype(jnp.int32)
            ez = (
                jax.random.uniform(kz, (n_trials, self.N_DATA)) < physical_rate
            ).astype(jnp.int32)
            fx = jnp.mean(self.logical_failure(ex, "x").astype(jnp.float32))
            fz = jnp.mean(self.logical_failure(ez, "z").astype(jnp.float32))
            return fx, fz

        fx, fz = run(kx, kz)
        return {
            "physical_rate": float(physical_rate),
            "logical_x_rate": float(fx),
            "logical_z_rate": float(fz),
            "suppression_factor": float(physical_rate / (float(fx) + 1e-12)),
            "n_trials": n_trials,
        }

    def pseudo_threshold(
        self, rates: Optional[np.ndarray] = None, n_trials: int = 50_000
    ) -> float:
        """Largest p where logical rate < physical rate (d=3 pseudo-threshold)."""
        if rates is None:
            rates = np.logspace(-3, -0.7, 12)
        best = 0.0
        for p in rates:
            res = self.logical_error_rate(float(p), n_trials)
            if res["logical_x_rate"] < p:
                best = float(p)
        return best


class TopologicalProtection:
    """Arrhenius model of topologically-protected information storage.

    Maps a device's energy barrier (e.g. skyrmion stability from
    devices/skyrmion_ops.py, reference skyrmion_device.py:255-291) to a
    per-operation physical error rate p = f0 * t_op * exp(-Delta E / kT),
    the quantity the codes above consume.
    """

    def __init__(self, attempt_frequency: float = 1e9):
        self.attempt_frequency = attempt_frequency

    def error_rate(
        self, energy_barrier: float, temperature: float, op_time: float = 1e-9
    ) -> float:
        if temperature <= 0 or energy_barrier < 0:
            return 0.0
        rate = self.attempt_frequency * np.exp(
            -energy_barrier / (KB * temperature)
        )
        return float(min(1.0, rate * op_time))

    def protection_factor(
        self, energy_barrier: float, temperature: float
    ) -> float:
        """exp(Delta/kT): how strongly the barrier suppresses thermal flips."""
        if temperature <= 0:
            return np.inf
        return float(np.exp(energy_barrier / (KB * temperature)))

    def stability_ratio(self, energy_barrier: float, temperature: float) -> float:
        """Delta = E_barrier / kT, the standard retention figure of merit."""
        if temperature <= 0:
            return np.inf
        return float(energy_barrier / (KB * temperature))


class SkyrmionErrorCorrection:
    """Repetition-coded skyrmion register with majority-vote decoding.

    A logical bit stored in ``n_copies`` skyrmion positions; thermal
    annihilation/nucleation flips copies independently with the
    TopologicalProtection rate; majority vote decodes. Batched Monte-Carlo
    over trials AND time steps in one jit.
    """

    def __init__(self, n_copies: int = 3, protection: Optional[TopologicalProtection] = None):
        if n_copies % 2 == 0:
            raise ValueError("n_copies must be odd for majority vote")
        self.n_copies = n_copies
        self.protection = protection or TopologicalProtection()

    def logical_error_rate(
        self,
        energy_barrier: float,
        temperature: float,
        op_time: float = 1e-9,
        n_trials: int = 100_000,
        seed: int = 0,
    ) -> Dict[str, float]:
        p = self.protection.error_rate(energy_barrier, temperature, op_time)
        key = jax.random.PRNGKey(seed)

        @jax.jit
        def run(key):
            flips = (
                jax.random.uniform(key, (n_trials, self.n_copies)) < p
            ).astype(jnp.int32)
            wrong = jnp.sum(flips, axis=-1) > self.n_copies // 2
            return jnp.mean(wrong.astype(jnp.float32))

        logical = float(run(key))
        return {
            "physical_rate": p,
            "logical_rate": logical,
            "suppression_factor": p / (logical + 1e-18),
            "n_copies": self.n_copies,
        }

    def retention_improvement(
        self, energy_barrier: float, temperature: float, target_rate: float = 1e-9
    ) -> Dict[str, float]:
        """Retention time with vs without coding at a target error budget."""
        p = self.protection.error_rate(energy_barrier, temperature)
        if p <= 0:
            return {"uncoded_s": np.inf, "coded_s": np.inf, "gain": 1.0}
        # uncoded: p per ns; coded: ~ C(n, (n+1)/2) p^((n+1)/2)
        from math import comb

        k = (self.n_copies + 1) // 2
        p_log = comb(self.n_copies, k) * p**k
        uncoded = target_rate / p * 1e-9
        coded = target_rate / max(p_log, 1e-300) * 1e-9
        return {"uncoded_s": uncoded, "coded_s": coded, "gain": coded / uncoded}


class LogicalQubitOperations:
    """Transversal logical operations on the d=3 surface code.

    Tracks the logical Pauli frame of a batch of encoded qubits: logical X/Z
    are bit flips of a (B, 2) frame array; logical CNOT acts on frame pairs.
    This is the Pauli-frame (Gottesman-Knill) picture - exactly what error-
    correction scaffolding needs, with O(1) cost instead of state vectors.
    """

    def __init__(self, code: Optional[SurfaceCodeErrorCorrection] = None):
        self.code = code or SurfaceCodeErrorCorrection()

    def init_frames(self, batch: int) -> jnp.ndarray:
        """(B, 2) int32 [x_frame, z_frame] logical Pauli frames, all |0>_L."""
        return jnp.zeros((batch, 2), jnp.int32)

    def logical_x(self, frames: jnp.ndarray) -> jnp.ndarray:
        return frames.at[:, 0].set(jnp.mod(frames[:, 0] + 1, 2))

    def logical_z(self, frames: jnp.ndarray) -> jnp.ndarray:
        return frames.at[:, 1].set(jnp.mod(frames[:, 1] + 1, 2))

    def logical_cnot(
        self, control: jnp.ndarray, target: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Transversal CNOT: X propagates control->target, Z target->control."""
        new_target = target.at[:, 0].set(jnp.mod(target[:, 0] + control[:, 0], 2))
        new_control = control.at[:, 1].set(jnp.mod(control[:, 1] + target[:, 1], 2))
        return new_control, new_target

    def measure_logical_z(
        self, frames: jnp.ndarray, errors: jnp.ndarray
    ) -> jnp.ndarray:
        """Logical Z outcome including residual-error flips for a (B, 9)
        physical X-error batch."""
        fail = self.code.logical_failure(errors, "x").astype(jnp.int32)
        return jnp.mod(frames[:, 0] + fail, 2)
