"""Policy/value networks for native training.

The reference delegates RL to stable-baselines3 (cli.py:89-107, torch on
host). Here training runs on the accelerator: a plain-JAX actor-critic MLP
whose parameters come with PartitionSpecs, so hidden layers can be
tensor-parallel sharded over the mesh 'model' axis while the env batch is
data-parallel over 'data'. For the small default MLP, TP is overkill - the
specs exist so the same train step scales to wide policies unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

_ACTIVATIONS = {"tanh": jnp.tanh, "relu": jax.nn.relu, "gelu": jax.nn.gelu}


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """MLP actor-critic.

    Continuous mode: outputs (mean, log_std) of a tanh-squashed Gaussian in
    [-1, 1]^act_dim plus the value estimate.
    Discrete mode: outputs logits over num_actions plus the value.

    Parameters are a dict of layers, each ``{"kernel": (in, out), "bias":
    (out,)}`` in float32, plus ``log_std`` in continuous mode. Kernels take
    orthogonal inits (scale sqrt(2) in the trunk, 0.01 in the actor head,
    1.0 in the value head); biases and ``log_std`` start at zero.
    """

    action_dim: int
    discrete: bool = False
    hidden_sizes: Sequence[int] = (256, 256)
    activation: str = "tanh"
    # Matmul compute dtype. None keeps the inputs' promotion (float64 on
    # the x64 test backend stays float64 end to end). 'bfloat16' casts
    # inputs and weights for the matmuls and casts the heads back to
    # float32 before any probability or loss math.
    compute_dtype: str | None = None
    # One trunk feeding both heads instead of separate actor/critic MLPs.
    shared_trunk: bool = False

    def _trunks(self) -> Tuple[str, ...]:
        return ("shared",) if self.shared_trunk else ("actor", "critic")

    def _layers(self, obs_dim: int):
        """(name, in_dim, out_dim, init scale, kernel spec, bias spec)."""
        layers = []
        for trunk in self._trunks():
            d = obs_dim
            for i, h in enumerate(self.hidden_sizes):
                # TP layout: even layers shard the output dim, odd layers the
                # input dim, so activations alternate sharded/replicated and
                # XLA inserts one all-reduce per pair (Megatron layout).
                if i % 2 == 0:
                    specs = (P(None, "model"), P("model"))
                else:
                    specs = (P("model", None), P())
                layers.append((f"{trunk}_dense_{i}", d, h, 2.0 ** 0.5) + specs)
                d = h
        d = self.hidden_sizes[-1] if self.hidden_sizes else obs_dim
        head = "actor_logits" if self.discrete else "actor_mean"
        layers.append((head, d, self.action_dim, 0.01, P(None, None), P()))
        layers.append(("critic_value", d, 1, 1.0, P(None, None), P()))
        return layers

    def init(self, key: jax.Array, sample_obs) -> Dict[str, Any]:
        """Fresh parameters for observations shaped like ``sample_obs``."""
        layers = self._layers(sample_obs.shape[-1])
        keys = jax.random.split(key, len(layers))
        params: Dict[str, Any] = {}
        for k, (name, d_in, d_out, scale, _, _) in zip(keys, layers):
            init = jax.nn.initializers.orthogonal(scale)
            params[name] = {
                "kernel": init(k, (d_in, d_out), jnp.float32),
                "bias": jnp.zeros((d_out,), jnp.float32),
            }
        if not self.discrete:
            params["log_std"] = jnp.zeros((self.action_dim,), jnp.float32)
        return params

    def partition_specs(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The tensor-parallel PartitionSpec tree matching ``params``."""
        obs_dim = next(iter(params.values()))["kernel"].shape[0]
        specs: Dict[str, Any] = {
            name: {"kernel": ks, "bias": bs}
            for name, _, _, _, ks, bs in self._layers(obs_dim)
        }
        if "log_std" in params:
            specs["log_std"] = P()
        return specs

    def apply(self, params: Dict[str, Any], obs):
        """Heads for a batch of observations: (logits, value) or
        (mean, log_std, value)."""
        act = _ACTIVATIONS[self.activation]
        cdtype = None if self.compute_dtype is None else jnp.dtype(self.compute_dtype)

        def dense(name, x):
            w, b = params[name]["kernel"], params[name]["bias"]
            dtype = cdtype or jnp.result_type(x, w, b)
            x, w, b = x.astype(dtype), w.astype(dtype), b.astype(dtype)
            return jnp.dot(x, w) + b

        def out(x):
            return x if cdtype is None else x.astype(jnp.float32)

        def trunk(name):
            x = obs
            for i in range(len(self.hidden_sizes)):
                x = act(dense(f"{name}_dense_{i}", x))
            return x

        if self.shared_trunk:
            pi = v = trunk("shared")
        else:
            pi, v = trunk("actor"), trunk("critic")
        value = out(dense("critic_value", v).squeeze(-1))
        if self.discrete:
            return out(dense("actor_logits", pi)), value
        return out(dense("actor_mean", pi)), params["log_std"], value


def continuous_action_transform(raw, max_current, max_duration):
    """Map tanh-squashed [-1, 1]^2 network output to env action space
    [(-J_max, J_max), (1e-12, dur_max)]."""
    current = raw[..., 0] * max_current
    duration = (raw[..., 1] + 1.0) * 0.5 * (max_duration - 1e-12) + 1e-12
    return jnp.stack([current, duration], axis=-1)


def gaussian_log_prob(mean, log_std, raw_action):
    """Diagonal Gaussian log-prob with tanh correction."""
    std = jnp.exp(log_std)
    pre_tanh = jnp.arctanh(jnp.clip(raw_action, -1 + 1e-6, 1 - 1e-6))
    logp = -0.5 * (((pre_tanh - mean) / std) ** 2 + 2 * log_std + jnp.log(2 * jnp.pi))
    logp = logp.sum(-1)
    # tanh change of variables
    logp -= jnp.log(1 - raw_action**2 + 1e-6).sum(-1)
    return logp


def sample_continuous(key, mean, log_std):
    std = jnp.exp(log_std)
    noise = jax.random.normal(key, mean.shape, mean.dtype)
    pre_tanh = mean + std * noise
    raw = jnp.tanh(pre_tanh)
    return raw, gaussian_log_prob(mean, log_std, raw)
