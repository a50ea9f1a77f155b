"""QAOA-style and ML-surrogate device-parameter optimizers.

Counterpart of the reference's quantum/optimization.py (754 LoC:
``QuantumMLDeviceOptimizer``, ``IterationFreeQAOA``, ``OptimizationResult``).
The reference's "iteration-free QAOA" is a NumPy loop sampling random angles;
here the same idea is made literal and accelerator-shaped: the full (gamma, beta)
angle grid is evaluated in ONE vmapped state-vector batch (grid^2 circuit
executions as a single XLA program - no variational loop at all), and the
returned angles are exact-expectation optima, not samples.

``QuantumMLDeviceOptimizer`` keeps the reference's capability (neural
surrogate + quantum-inspired search over device parameters) with an honest
mechanism: an MLP surrogate trained by jax.grad on batched physics
evaluations, refined by gradient ascent THROUGH the surrogate, validated
against the real vmapped objective.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..research.optimizers import OptimizationResult
from . import statevector as sv

__all__ = ["IterationFreeQAOA", "QuantumMLDeviceOptimizer", "OptimizationResult"]


class IterationFreeQAOA:
    """Depth-p QAOA for QUBO problems with grid-batch angle selection.

    minimize  x^T Q x  over x in {0,1}^n

    The cost Hamiltonian is diagonal, so cost expectations come from the
    probability vector directly; the mixer is a product of RX gates. All
    ``grid_points**2p`` angle settings evaluate in one vmapped batch.
    """

    def __init__(self, n_layers: int = 1, grid_points: int = 24, max_qubits: int = 14):
        if n_layers < 1:
            raise ValueError("n_layers >= 1")
        self.n_layers = n_layers
        self.grid_points = grid_points
        self.max_qubits = max_qubits

    # -- problem encoding ---------------------------------------------------
    @staticmethod
    def qubo_cost_vector(Q: np.ndarray) -> jnp.ndarray:
        """Cost of every bitstring: c[k] = x_k^T Q x_k, computed as one
        (2^n, n) @ (n, n) @ (n, 2^n) batched contraction."""
        Q = jnp.asarray(Q, jnp.float32)
        n = Q.shape[0]
        idx = jnp.arange(2**n)
        bits = ((idx[:, None] >> jnp.arange(n)[None, :]) & 1).astype(jnp.float32)
        return jnp.einsum("ki,ij,kj->k", bits, Q, bits)

    def _evolve(self, angles: jnp.ndarray, cost: jnp.ndarray, n: int) -> jnp.ndarray:
        """|gamma,beta> for one angle setting; angles = (2p,) [gammas, betas].

        Real-pair state: the diagonal phase e^{-i gamma c} is a 2x2 real
        rotation of the (Re, Im) planes - fully fused elementwise math."""
        amp = 1.0 / jnp.sqrt(2.0**n)
        re = jnp.full((2**n,), amp, jnp.float32)
        im = jnp.zeros((2**n,), jnp.float32)
        gammas, betas = angles[: self.n_layers], angles[self.n_layers :]
        for layer in range(self.n_layers):
            # cost layer: (re + i im) * (cos phi - i sin phi), phi = gamma*c
            phi = gammas[layer] * cost
            c, s = jnp.cos(phi), jnp.sin(phi)
            re, im = re * c + im * s, im * c - re * s
            # mixer: RX(2 beta) on every wire
            state = jnp.stack([re, im])
            gate = sv.rx(2.0 * betas[layer])
            for w in range(n):
                state = sv.apply_gate(state, gate, (w,))
            re, im = state[0], state[1]
        return jnp.stack([re, im])

    def optimize(self, Q: np.ndarray, seed: int = 0) -> OptimizationResult:
        Q = np.asarray(Q, np.float64)
        n = Q.shape[0]
        if n > self.max_qubits:
            raise ValueError(
                f"{n} variables > max_qubits={self.max_qubits} for exact simulation"
            )
        cost = self.qubo_cost_vector(Q)

        p = self.n_layers
        if p == 1:
            g = jnp.linspace(0.0, jnp.pi, self.grid_points)
            b = jnp.linspace(0.0, jnp.pi / 2, self.grid_points)
            gg, bb = jnp.meshgrid(g, b, indexing="ij")
            angle_batch = jnp.stack([gg.reshape(-1), bb.reshape(-1)], axis=-1)
        else:
            # for p > 1 the grid is sampled (grid^2p explodes); still a single
            # batched evaluation.
            key = jax.random.PRNGKey(seed)
            n_samples = self.grid_points**2
            lo = jnp.concatenate([jnp.zeros(p), jnp.zeros(p)])
            hi = jnp.concatenate([jnp.full(p, jnp.pi), jnp.full(p, jnp.pi / 2)])
            angle_batch = jax.random.uniform(
                key, (n_samples, 2 * p), minval=lo, maxval=hi
            )

        @jax.jit
        def batch_expectation(batch):
            def one(angles):
                psi = self._evolve(angles, cost, n)
                return jnp.sum(sv.probabilities(psi) * cost)

            return jax.vmap(one)(batch)

        values = batch_expectation(angle_batch)
        best_idx = int(jnp.argmin(values))
        best_angles = angle_batch[best_idx]

        # most-likely bitstring under the best angles = solution readout
        psi = self._evolve(best_angles, cost, n)
        probs = np.asarray(sv.probabilities(psi))
        best_bit = int(np.argmax(probs))
        x = np.array([(best_bit >> i) & 1 for i in range(n)], np.float64)
        exact_best = int(np.argmin(np.asarray(cost)))

        return OptimizationResult(
            best_params={
                **{f"x{i}": float(x[i]) for i in range(n)},
                **{f"gamma{l}": float(best_angles[l]) for l in range(p)},
                **{f"beta{l}": float(best_angles[p + l]) for l in range(p)},
            },
            best_value=float(x @ Q @ x),
            history=np.asarray([float(values[best_idx])]),
            n_evaluations=int(values.shape[0]),
            method=f"iteration_free_qaoa_p{p}",
        )

    def approximation_ratio(self, Q: np.ndarray, result: OptimizationResult) -> float:
        """Achieved cost / exact optimum (1.0 = optimal; guards zero optimum)."""
        cost = np.asarray(self.qubo_cost_vector(np.asarray(Q)))
        exact = float(cost.min())
        achieved = result.best_value
        if abs(exact) < 1e-12:
            return 1.0 if abs(achieved) < 1e-12 else 0.0
        return achieved / exact


def _mlp_init(key, sizes: Sequence[int]):
    params = []
    for kin, kout in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (kin, kout)) * jnp.sqrt(2.0 / kin)
        params.append((w, jnp.zeros((kout,))))
    return params


def _mlp_apply(params, x):
    for w, b in params[:-1]:
        x = jax.nn.tanh(x @ w + b)
    w, b = params[-1]
    return (x @ w + b)[..., 0]


class QuantumMLDeviceOptimizer:
    """Surrogate-model device-parameter optimizer.

    1. Sample ``n_train`` parameter vectors; evaluate the TRUE objective in
       one vmapped physics batch.
    2. Fit an MLP surrogate by full-batch Adam (jax.grad, jit-compiled).
    3. Descend THROUGH the surrogate from many random starts at once
       (vmapped gradient descent - the reference's "quantum ML" step).
    4. Re-rank candidate minima with the true objective; return the best.
    """

    def __init__(
        self,
        hidden_sizes: Sequence[int] = (64, 64),
        n_train: int = 2048,
        train_steps: int = 500,
        refine_starts: int = 256,
        refine_steps: int = 100,
        learning_rate: float = 1e-2,
    ):
        self.hidden_sizes = tuple(hidden_sizes)
        self.n_train = n_train
        self.train_steps = train_steps
        self.refine_starts = refine_starts
        self.refine_steps = refine_steps
        self.learning_rate = learning_rate

    def optimize(
        self,
        objective: Callable[[Dict[str, jnp.ndarray]], jnp.ndarray],
        space: Dict[str, Tuple[float, float]],
        seed: int = 0,
    ) -> OptimizationResult:
        names = list(space)
        lo = jnp.asarray([space[n][0] for n in names])
        hi = jnp.asarray([space[n][1] for n in names])
        dim = len(names)
        key = jax.random.PRNGKey(seed)

        def to_dict(x01):  # (B, dim) in [0,1] -> parameter dict
            x = lo + (hi - lo) * x01
            return {n: x[:, i] for i, n in enumerate(names)}

        # 1. training data from the real physics, one vmapped call
        key, sub = jax.random.split(key)
        x_train = jax.random.uniform(sub, (self.n_train, dim))
        y_train = jnp.asarray(objective(to_dict(x_train)))
        y_mean, y_std = jnp.mean(y_train), jnp.std(y_train) + 1e-8
        y_norm = (y_train - y_mean) / y_std

        # 2. surrogate fit
        key, sub = jax.random.split(key)
        params = _mlp_init(sub, (dim, *self.hidden_sizes, 1))

        def loss_fn(p):
            pred = _mlp_apply(p, x_train)
            return jnp.mean((pred - y_norm) ** 2)

        lr = self.learning_rate

        @jax.jit
        def train(params):
            # Adam state
            flat, tree = jax.tree_util.tree_flatten(params)
            m = [jnp.zeros_like(f) for f in flat]
            v = [jnp.zeros_like(f) for f in flat]

            def step(carry, i):
                flat, m, v = carry
                p = jax.tree_util.tree_unflatten(tree, flat)
                grads = jax.grad(loss_fn)(p)
                gflat, _ = jax.tree_util.tree_flatten(grads)
                t = i + 1.0
                new_flat, new_m, new_v = [], [], []
                for f, g, mi, vi in zip(flat, gflat, m, v):
                    mi = 0.9 * mi + 0.1 * g
                    vi = 0.999 * vi + 0.001 * g * g
                    mhat = mi / (1 - 0.9**t)
                    vhat = vi / (1 - 0.999**t)
                    new_flat.append(f - lr * mhat / (jnp.sqrt(vhat) + 1e-8))
                    new_m.append(mi)
                    new_v.append(vi)
                return (new_flat, new_m, new_v), loss_fn(
                    jax.tree_util.tree_unflatten(tree, new_flat)
                )

            (flat, _, _), losses = jax.lax.scan(
                step, (flat, m, v), jnp.arange(self.train_steps, dtype=jnp.float32)
            )
            return jax.tree_util.tree_unflatten(tree, flat), losses

        params, losses = train(params)

        # 3. vmapped multi-start descent through the surrogate
        key, sub = jax.random.split(key)
        starts = jax.random.uniform(sub, (self.refine_starts, dim))

        @jax.jit
        def refine(x0):
            def surr(x):
                return _mlp_apply(params, x[None, :])[0]

            def step(x, _):
                g = jax.grad(surr)(x)
                x = jnp.clip(x - 0.05 * g, 0.0, 1.0)
                return x, None

            x, _ = jax.lax.scan(step, x0, None, length=self.refine_steps)
            return x

        refined = jax.vmap(refine)(starts)

        # 4. re-rank with the REAL objective
        candidates = jnp.concatenate([refined, x_train[jnp.argsort(y_train)[:32]]])
        true_vals = jnp.asarray(objective(to_dict(candidates)))
        best = int(jnp.argmin(true_vals))
        x_best = lo + (hi - lo) * candidates[best]

        return OptimizationResult(
            best_params={n: float(x_best[i]) for i, n in enumerate(names)},
            best_value=float(true_vals[best]),
            history=np.asarray(losses),
            n_evaluations=int(self.n_train + candidates.shape[0]),
            method="quantum_ml_surrogate",
        )
