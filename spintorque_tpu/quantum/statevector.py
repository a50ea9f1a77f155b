"""Batched state-vector quantum simulation core (real-pair representation).

accelerator-native foundation for the quantum add-on tier (SURVEY.md section 2.8).
The reference implements its "quantum" modules as per-amplitude Python/NumPy
loops inside ~6k LoC of scaffolding (quantum/hybrid_computing.py:449-736
ProgrammableQuantumSimulator, research/quantum_machine_learning.py). Here the
simulator is a set of pure functions over REAL-PAIR states:

    state: (..., 2, 2**n) float32, state[..., 0, :] = Re, [..., 1, :] = Im

Complex arithmetic is expanded into real matmuls explicitly ((a+bi)(c+di)
-> 4 real tensordots) rather than using complex64, for two reasons:
  * it is the matmul-shaped form - XLA lowers complex matmul to exactly
    these real products anyway, and f32 matmuls are the native fast path;
  * some accelerator backends do not implement complex primitives at all;
    the real-pair form runs everywhere float32 runs.

Gates are (2, 2^k, 2^k) real pairs; ``GATES`` also keeps the plain complex
NumPy matrices for host-side algebra (circuit optimization / compilation).
Everything composes with jit/vmap/grad, so variational optimizers get EXACT
autodiff gradients instead of the reference's finite differences
(quantum/optimization.py:34-47). States are little-endian: wire 0 is the
least-significant bit of the amplitude index.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "zero_state",
    "basis_state",
    "from_complex",
    "to_complex",
    "apply_gate",
    "apply_gate_batched",
    "expectation_pauli",
    "expectation_z",
    "probabilities",
    "sample_counts",
    "fidelity",
    "GATES",
    "gate_pair",
    "rx",
    "ry",
    "rz",
    "phase",
    "u3",
    "crz",
]

# ---------------------------------------------------------------------------
# Gate matrices (host-side complex form, for algebra and conversion)

_SQRT2 = 1.0 / math.sqrt(2.0)

GATES = {
    "I": np.eye(2, dtype=np.complex64),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex64),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex64),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex64),
    "H": np.array([[_SQRT2, _SQRT2], [_SQRT2, -_SQRT2]], dtype=np.complex64),
    "S": np.array([[1, 0], [0, 1j]], dtype=np.complex64),
    "SDG": np.array([[1, 0], [0, -1j]], dtype=np.complex64),
    "T": np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex64),
    "CNOT": np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
        dtype=np.complex64,
    ),
    "CZ": np.diag([1, 1, 1, -1]).astype(np.complex64),
    "SWAP": np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.complex64,
    ),
}


def gate_pair(mat) -> jnp.ndarray:
    """Complex (m, m) matrix -> (2, m, m) float32 real pair."""
    mat = np.asarray(mat)
    return jnp.stack(
        [jnp.asarray(mat.real, jnp.float32), jnp.asarray(mat.imag, jnp.float32)]
    )


def rx(theta) -> jnp.ndarray:
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    re = jnp.stack([jnp.stack([c, z]), jnp.stack([z, c])])
    im = jnp.stack([jnp.stack([z, -s]), jnp.stack([-s, z])])
    return jnp.stack([re, im])


def ry(theta) -> jnp.ndarray:
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    re = jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])
    return jnp.stack([re, jnp.zeros_like(re)])


def rz(theta) -> jnp.ndarray:
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    re = jnp.stack([jnp.stack([c, z]), jnp.stack([z, c])])
    im = jnp.stack([jnp.stack([-s, z]), jnp.stack([z, s])])
    return jnp.stack([re, im])


def phase(phi) -> jnp.ndarray:
    phi = jnp.asarray(phi, jnp.float32)
    one = jnp.ones_like(phi)
    z = jnp.zeros_like(phi)
    re = jnp.stack([jnp.stack([one, z]), jnp.stack([z, jnp.cos(phi)])])
    im = jnp.stack([jnp.stack([z, z]), jnp.stack([z, jnp.sin(phi)])])
    return jnp.stack([re, im])


def u3(theta, phi, lam) -> jnp.ndarray:
    """General single-qubit rotation (OpenQASM u3 convention)."""
    theta = jnp.asarray(theta, jnp.float32)
    phi = jnp.asarray(phi, jnp.float32)
    lam = jnp.asarray(lam, jnp.float32)
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    re = jnp.stack(
        [
            jnp.stack([c, -jnp.cos(lam) * s]),
            jnp.stack([jnp.cos(phi) * s, jnp.cos(phi + lam) * c]),
        ]
    )
    im = jnp.stack(
        [
            jnp.stack([jnp.zeros_like(c), -jnp.sin(lam) * s]),
            jnp.stack([jnp.sin(phi) * s, jnp.sin(phi + lam) * c]),
        ]
    )
    return jnp.stack([re, im])


def crz(theta) -> jnp.ndarray:
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
    re = jnp.eye(4, dtype=jnp.float32)
    re = re.at[2, 2].set(c).at[3, 3].set(c)
    im = jnp.zeros((4, 4), jnp.float32)
    im = im.at[2, 2].set(-s).at[3, 3].set(s)
    return jnp.stack([re, im])


# ---------------------------------------------------------------------------
# States

def zero_state(n_qubits: int, dtype=jnp.float32) -> jnp.ndarray:
    state = jnp.zeros((2, 2**n_qubits), dtype)
    return state.at[0, 0].set(1.0)


def basis_state(n_qubits: int, index: int, dtype=jnp.float32) -> jnp.ndarray:
    state = jnp.zeros((2, 2**n_qubits), dtype)
    return state.at[0, index].set(1.0)


def from_complex(arr) -> jnp.ndarray:
    """Complex (..., 2**n) array -> (..., 2, 2**n) real pair."""
    arr = np.asarray(arr)
    return jnp.stack(
        [jnp.asarray(arr.real, jnp.float32), jnp.asarray(arr.imag, jnp.float32)],
        axis=-2,
    )


def to_complex(state) -> np.ndarray:
    """(..., 2, 2**n) real pair -> complex NumPy array (host-side)."""
    arr = np.asarray(state)
    return arr[..., 0, :] + 1j * arr[..., 1, :]


# ---------------------------------------------------------------------------
# Gate application

def _wire_axes(n_qubits: int, wires: Sequence[int]) -> Tuple[int, ...]:
    # State component reshaped to (2,)*n with axis 0 = MOST significant bit;
    # wire w (little-endian) lives on axis n-1-w.
    return tuple(n_qubits - 1 - w for w in wires)


def _tensordot_restore(gmat, psi, axes, n, k):
    """tensordot over wire axes + transpose restoring original axis order.

    precision=HIGHEST: float32 matmuls may otherwise run in TF32 on the GPU,
    which loses ~3 decimal digits per gate on the state's unit norm; gate
    application must run full f32 (cost is negligible at 2^k x 2^k x 2^(n-k)).
    """
    out = jnp.tensordot(
        gmat, psi, axes=(tuple(range(k, 2 * k)), axes),
        precision=jax.lax.Precision.HIGHEST,
    )
    remaining = [a for a in range(n) if a not in axes]
    order = [0] * n
    for pos, ax in enumerate(axes):
        order[ax] = pos
    for pos, ax in enumerate(remaining):
        order[ax] = k + pos
    return jnp.transpose(out, order)


def apply_gate(state: jnp.ndarray, gate: jnp.ndarray, wires: Sequence[int]) -> jnp.ndarray:
    """Apply a k-qubit gate to ``wires`` of a (2, 2**n) real-pair state.

    (G_r + i G_i)(psi_r + i psi_i): four real tensordots, each a
    (2^k x 2^k) @ (2^k x 2^(n-k)) f32 matmul.

    ``gate`` is a (2, 2^k, 2^k) real pair (see ``gate_pair``); a plain
    complex matrix is converted on the fly for convenience.
    """
    n = int(round(math.log2(state.shape[-1])))
    # Accept host-side complex matrices for convenience; convert BEFORE any
    # device transfer (some accelerator backends reject complex buffers).
    if isinstance(gate, np.ndarray) and (np.iscomplexobj(gate) or gate.ndim == 2):
        gate = gate_pair(gate)
    else:
        gate = jnp.asarray(gate, jnp.float32)
    k = int(gate.shape[-1]).bit_length() - 1
    gr = gate[0].reshape((2,) * (2 * k))
    gi = gate[1].reshape((2,) * (2 * k))
    sr = state[0].reshape((2,) * n)
    si = state[1].reshape((2,) * n)
    axes = _wire_axes(n, wires)
    rr = _tensordot_restore(gr, sr, axes, n, k)
    ii = _tensordot_restore(gi, si, axes, n, k)
    ri = _tensordot_restore(gr, si, axes, n, k)
    ir = _tensordot_restore(gi, sr, axes, n, k)
    out_r = (rr - ii).reshape(state.shape[-1])
    out_i = (ri + ir).reshape(state.shape[-1])
    return jnp.stack([out_r, out_i])


def apply_gate_batched(states: jnp.ndarray, gate: jnp.ndarray, wires: Sequence[int]) -> jnp.ndarray:
    """vmapped apply_gate over a (B, 2, 2**n) batch of states."""
    return jax.vmap(lambda s: apply_gate(s, gate, wires))(states)


# ---------------------------------------------------------------------------
# Measurement / expectation

def expectation_pauli(state: jnp.ndarray, pauli: str, coeff: float = 1.0):
    """<psi| P |psi> for a Pauli string like 'ZZI' (left = highest wire).

    Strings are big-endian to read like ket labels: pauli[0] acts on wire
    n-1. Use 'I' for untouched wires. Result is the (real) expectation.
    """
    n = int(round(math.log2(state.shape[-1])))
    if len(pauli) != n:
        raise ValueError(f"Pauli string length {len(pauli)} != {n} qubits")
    psi = state
    for i, p in enumerate(pauli):
        if p == "I":
            continue
        wire = n - 1 - i
        psi = apply_gate(psi, gate_pair(GATES[p]), (wire,))
    # Re<state|psi> = sr.pr + si.pi
    return coeff * (jnp.sum(state[0] * psi[0]) + jnp.sum(state[1] * psi[1]))


def expectation_z(state: jnp.ndarray, wire: int) -> jnp.ndarray:
    """<Z_wire> via probability differences (no gate application needed)."""
    probs = probabilities(state)
    idx = jnp.arange(state.shape[-1])
    signs = 1.0 - 2.0 * ((idx >> wire) & 1)
    return jnp.sum(probs * signs)


def probabilities(state: jnp.ndarray) -> jnp.ndarray:
    return state[..., 0, :] ** 2 + state[..., 1, :] ** 2


def sample_counts(state: jnp.ndarray, key: jax.Array, shots: int) -> jnp.ndarray:
    """Sample measurement outcomes; returns (shots,) basis-state indices."""
    p = probabilities(state)
    p = p / jnp.sum(p)
    return jax.random.choice(key, state.shape[-1], (shots,), p=p)


def fidelity(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """|<a|b>|^2 for real-pair states."""
    re = jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])
    im = jnp.sum(a[0] * b[1]) - jnp.sum(a[1] * b[0])
    return re * re + im * im
