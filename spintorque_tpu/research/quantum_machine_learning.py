"""Variational quantum machine learning on the batched state-vector core.

Counterpart of the reference's research/quantum_machine_learning.py (892 LoC:
``QuantumSpinOptimizer`` :28, ``QuantumNeuralNetwork`` :398,
``QuantumReinforcementLearning`` :636 - a module that is import-broken in
the reference, importing a nonexistent ``BaseDevice``; SURVEY.md section 2).
Here every model is a differentiable jax program over real-pair states
(quantum/statevector.py): QNN training is full-batch Adam with EXACT
autodiff gradients (the reference sketches parameter-shift loops), and the
quantum RL policy trains with REINFORCE over exact expectation values.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..quantum import statevector as sv
from ..quantum.energy_landscape import SymmetryEnhancedVQE

__all__ = [
    "QuantumSpinOptimizer",
    "QuantumNeuralNetwork",
    "QuantumReinforcementLearning",
]


class QuantumSpinOptimizer:
    """Spin-configuration optimizer: Ising energies via VQE.

    Maps an Ising problem (couplings J_ij, fields h_i over classical spins
    s in {-1, +1}) to a diagonal Hamiltonian and minimizes it with the
    symmetry-enhanced VQE. Exact cost enumeration is one (2^n, n) @ (n, n)
    batched contraction - the accelerator-shaped path for n <= 14.
    """

    def __init__(self, n_layers: int = 3, iterations: int = 300, seed: int = 0):
        self.n_layers = n_layers
        self.iterations = iterations
        self.seed = seed

    @staticmethod
    def ising_cost_vector(J: np.ndarray, h: Optional[np.ndarray] = None) -> jnp.ndarray:
        J = jnp.asarray(np.triu(np.asarray(J), 1), jnp.float32)
        n = J.shape[0]
        h = jnp.zeros((n,), jnp.float32) if h is None else jnp.asarray(h, jnp.float32)
        idx = jnp.arange(2**n)
        spins = 1.0 - 2.0 * ((idx[:, None] >> jnp.arange(n)[None, :]) & 1)
        return jnp.einsum("ki,ij,kj->k", spins, J, spins) + spins @ h

    def optimize(self, J: np.ndarray, h: Optional[np.ndarray] = None) -> Dict[str, Any]:
        cost = self.ising_cost_vector(J, h)
        n = int(np.log2(cost.shape[0]))
        vqe = SymmetryEnhancedVQE(
            n, n_layers=self.n_layers, iterations=self.iterations, seed=self.seed
        )
        res = vqe.minimize_diagonal(cost)
        idx = res["ground_state_index"]
        spins = np.asarray([1 - 2 * ((idx >> i) & 1) for i in range(n)])
        res["spins"] = spins
        res["spin_energy"] = float(cost[idx])
        return res


def _reupload_circuit(x: jnp.ndarray, params: jnp.ndarray, n_qubits: int):
    """Data-reuploading VQC: alternating feature encodings and trainable
    rotations with ring entanglement; params (n_blocks, n_qubits, 2)."""
    state = sv.zero_state(n_qubits)
    n_blocks = params.shape[0]
    cz = sv.gate_pair(sv.GATES["CZ"])
    for b in range(n_blocks):
        for w in range(n_qubits):
            # encode feature w (cycled) then trainable RY/RZ
            feat = x[w % x.shape[0]]
            state = sv.apply_gate(state, sv.ry(feat), (w,))
            state = sv.apply_gate(state, sv.ry(params[b, w, 0]), (w,))
            state = sv.apply_gate(state, sv.rz(params[b, w, 1]), (w,))
        for w in range(n_qubits - 1):
            state = sv.apply_gate(state, cz, (w, w + 1))
    return state


class QuantumNeuralNetwork:
    """Data-reuploading variational quantum classifier/regressor.

    Output is <Z_0> of the final state in [-1, 1]. Training: full-batch Adam
    with exact autodiff gradients; the batch dimension is vmapped, so one
    training step is a single XLA program over all samples.
    """

    def __init__(
        self,
        n_qubits: int = 4,
        n_blocks: int = 3,
        learning_rate: float = 0.05,
        seed: int = 0,
    ):
        self.n_qubits = n_qubits
        self.n_blocks = n_blocks
        self.learning_rate = learning_rate
        key = jax.random.PRNGKey(seed)
        self.params = 0.1 * jax.random.normal(key, (n_blocks, n_qubits, 2))

    def forward(self, params: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        state = _reupload_circuit(x, params, self.n_qubits)
        return sv.expectation_z(state, 0)

    def predict(self, X: jnp.ndarray) -> jnp.ndarray:
        return jax.vmap(lambda x: self.forward(self.params, x))(jnp.asarray(X, jnp.float32))

    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        epochs: int = 100,
    ) -> Dict[str, Any]:
        X = jnp.asarray(X, jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        lr = self.learning_rate

        def loss_fn(params):
            preds = jax.vmap(lambda x: self.forward(params, x))(X)
            return jnp.mean((preds - y) ** 2)

        @jax.jit
        def train(params):
            def step(carry, t):
                p, m, v = carry
                g = jax.grad(loss_fn)(p)
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                mh = m / (1 - 0.9 ** (t + 1))
                vh = v / (1 - 0.999 ** (t + 1))
                p = p - lr * mh / (jnp.sqrt(vh) + 1e-8)
                return (p, m, v), loss_fn(p)

            (p, _, _), hist = jax.lax.scan(
                step,
                (params, jnp.zeros_like(params), jnp.zeros_like(params)),
                jnp.arange(epochs, dtype=jnp.float32),
            )
            return p, hist

        self.params, history = train(self.params)
        return {
            "loss_history": np.asarray(history),
            "final_loss": float(history[-1]),
            "n_parameters": int(self.params.size),
        }

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        """Binary accuracy with sign(output) labels in {-1, +1}."""
        preds = np.sign(np.asarray(self.predict(X)))
        return float(np.mean(preds == np.sign(np.asarray(y))))


class QuantumReinforcementLearning:
    """VQC softmax policy trained with REINFORCE on a bandit-style
    switching task.

    The task: choose one of ``n_actions`` pulse settings given a (small)
    observation; reward from a user-supplied function (e.g. switching
    success from the physics engine). Policy logits are per-action Pauli-Z
    expectations of a reuploading circuit; gradients are exact.
    """

    def __init__(
        self,
        n_obs_features: int,
        n_actions: int,
        n_qubits: Optional[int] = None,
        n_blocks: int = 2,
        learning_rate: float = 0.1,
        seed: int = 0,
    ):
        self.n_actions = n_actions
        self.n_qubits = n_qubits or max(n_actions.bit_length(), n_obs_features, 2)
        if self.n_qubits < n_actions.bit_length():
            raise ValueError("need >= log2(n_actions) qubits")
        self.n_blocks = n_blocks
        self.learning_rate = learning_rate
        key = jax.random.PRNGKey(seed)
        self.params = 0.1 * jax.random.normal(key, (n_blocks, self.n_qubits, 2))

    def logits(self, params: jnp.ndarray, obs: jnp.ndarray) -> jnp.ndarray:
        state = _reupload_circuit(obs, params, self.n_qubits)
        zs = jnp.stack(
            [sv.expectation_z(state, w % self.n_qubits) for w in range(self.n_actions)]
        )
        return 3.0 * zs  # scale expectations into a usable logit range

    def act(self, obs: jnp.ndarray, key: jax.Array) -> int:
        p = jax.nn.softmax(self.logits(self.params, jnp.asarray(obs, jnp.float32)))
        return int(jax.random.choice(key, self.n_actions, p=p))

    def train(
        self,
        sample_obs: Callable[[jax.Array], jnp.ndarray],
        reward_fn: Callable[[jnp.ndarray, int], float],
        episodes: int = 200,
        batch: int = 32,
        seed: int = 0,
    ) -> Dict[str, Any]:
        lr = self.learning_rate
        key = jax.random.PRNGKey(seed)
        rewards_hist: List[float] = []
        params = self.params
        m = jnp.zeros_like(params)
        v = jnp.zeros_like(params)

        logits_fn = self.logits

        @jax.jit
        def update(params, m, v, obs_b, act_b, adv_b, t):
            def loss_fn(p):
                logp = jax.vmap(
                    lambda o, a: jax.nn.log_softmax(logits_fn(p, o))[a]
                )(obs_b, act_b)
                return -jnp.mean(logp * adv_b)

            g = jax.grad(loss_fn)(params)
            m2 = 0.9 * m + 0.1 * g
            v2 = 0.999 * v + 0.001 * g * g
            mh = m2 / (1 - 0.9 ** (t + 1))
            vh = v2 / (1 - 0.999 ** (t + 1))
            return params - lr * mh / (jnp.sqrt(vh) + 1e-8), m2, v2

        for ep in range(episodes):
            key, k_obs, k_act = jax.random.split(key, 3)
            obs_b = jax.vmap(sample_obs)(jax.random.split(k_obs, batch))
            p_b = jax.vmap(
                lambda o: jax.nn.softmax(logits_fn(params, o))
            )(obs_b)
            act_keys = jax.random.split(k_act, batch)
            act_b = jnp.stack(
                [jax.random.choice(k, self.n_actions, p=p)
                 for k, p in zip(act_keys, p_b)]
            )
            rew_b = jnp.asarray(
                [reward_fn(np.asarray(o), int(a)) for o, a in zip(obs_b, act_b)],
                jnp.float32,
            )
            adv_b = rew_b - jnp.mean(rew_b)
            params, m, v = update(
                params, m, v, obs_b, act_b, adv_b, jnp.float32(ep)
            )
            rewards_hist.append(float(jnp.mean(rew_b)))

        self.params = params
        return {
            "reward_history": np.asarray(rewards_hist),
            "final_mean_reward": float(np.mean(rewards_hist[-10:])),
            "episodes": episodes,
        }
