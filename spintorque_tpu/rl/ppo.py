"""Native on-device PPO trainer.

Replaces the reference's stable-baselines3 delegation (cli.py:89-129) with a
fully on-device trainer: rollout (lax.scan over the fused env step), GAE,
and minibatched clipped-surrogate updates are one jitted program. Under a
('data', 'model') mesh the env batch and rollout tensors shard over 'data'
(pure DP, zero collectives in the env loop), policy parameters shard over
'model' (TP), and gradients reduce with one psum inserted by XLA.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..envs.spin_torque import EnvState, SpinTorqueEnv
from .networks import (
    ActorCritic,
    continuous_action_transform,
    gaussian_log_prob,
    sample_continuous,
)


class PPOConfig(NamedTuple):
    rollout_steps: int = 16
    num_epochs: int = 4
    num_minibatches: int = 4
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden_sizes: Tuple[int, ...] = (256, 256)
    # Network matmul compute dtype ('float32' | 'bfloat16'). bfloat16 runs
    # the policy/value Dense layers in bf16 with float32
    # params/optimizer/loss math (see networks.ActorCritic.compute_dtype).
    compute_dtype: str = "float32"
    # One trunk for both heads (standard PPO option): halves the trunk
    # matmul work in rollout and update (networks.ActorCritic.shared_trunk).
    shared_trunk: bool = False


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: EnvState
    obs: Any
    key: jax.Array
    update_count: jnp.ndarray


class PPOTrainer:
    """PPO over a vectorized SpinTorqueEnv, optionally on a device mesh."""

    def __init__(
        self,
        env: SpinTorqueEnv,
        config: PPOConfig = PPOConfig(),
        mesh=None,
    ):
        self.env = env
        self.config = config
        self.mesh = mesh
        if mesh is not None and getattr(env, "mesh", None) is None:
            # The env must know the mesh so its GPU kernel runs per shard
            # (no batch data crosses cards inside the rollout hot loop).
            env.mesh = mesh
        if env.config.observation_mode != "vector":
            raise ValueError(
                "PPOTrainer requires observation_mode='vector' (dict "
                "observations need a custom network; see rl/networks.py)"
            )
        self.discrete = env.config.action_mode == "discrete"
        self.network = ActorCritic(
            action_dim=env.num_actions if self.discrete else 2,
            discrete=self.discrete,
            hidden_sizes=config.hidden_sizes,
            compute_dtype=config.compute_dtype,
            shared_trunk=config.shared_trunk,
        )
        self.tx = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(config.learning_rate),
        )
        self._train_step = jax.jit(self._train_step_impl)

    # ------------------------------------------------------------------ setup

    def init(self, key: jax.Array) -> TrainState:
        k_env, k_net, k_loop = jax.random.split(key, 3)
        env_state, obs = self.env.reset(k_env)
        sample_obs = obs[:1] if not isinstance(obs, dict) else jax.tree.map(lambda x: x[:1], obs)
        params = self.network.init(k_net, sample_obs)
        self.param_specs = self.network.partition_specs(params)
        if self.mesh is not None:
            # Place params by their annotated TP PartitionSpecs and shard the
            # env batch over 'data'; XLA propagates the rest.
            mesh = self.mesh
            params = jax.tree.map(
                lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
                params,
                self.param_specs,
            )
            from ..parallel.mesh import shard_env_state

            env_state = shard_env_state(env_state, mesh)
            obs = jax.device_put(obs, NamedSharding(mesh, P("data")))
        opt_state = self.tx.init(params)
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=k_loop,
            update_count=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------------ policy

    def _policy(self, params, obs, key):
        out = self.network.apply(params, obs)
        if self.discrete:
            logits, value = out
            action = jax.random.categorical(key, logits)
            log_prob = jax.nn.log_softmax(logits)[
                jnp.arange(action.shape[0]), action
            ]
            return action, action, log_prob, value
        mean, log_std, value = out
        raw, log_prob = sample_continuous(key, mean, log_std)
        env_action = continuous_action_transform(
            raw, self.env.config.max_current, self.env.config.max_duration
        )
        return env_action, raw, log_prob, value

    def _evaluate_actions(self, params, obs, raw_actions):
        out = self.network.apply(params, obs)
        if self.discrete:
            logits, value = out
            logp_all = jax.nn.log_softmax(logits)
            log_prob = jnp.take_along_axis(
                logp_all, raw_actions[..., None].astype(jnp.int32), axis=-1
            ).squeeze(-1)
            entropy = -(jnp.exp(logp_all) * logp_all).sum(-1)
            return log_prob, entropy, value
        mean, log_std, value = out
        log_prob = gaussian_log_prob(mean, log_std, raw_actions)
        entropy = (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum(-1)
        entropy = jnp.broadcast_to(entropy, log_prob.shape)
        return log_prob, entropy, value

    # ------------------------------------------------------------------ train

    def _train_step_impl(self, ts: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
        cfg = self.config
        env = self.env

        def rollout_step(carry, step_key):
            env_state, obs = carry
            env_action, raw_action, log_prob, value = self._policy(
                ts.params, obs, step_key
            )
            next_state, step_out = env._step_impl(env_state, env_action)
            transition = dict(
                obs=obs,
                raw_action=raw_action,
                reward=step_out.reward,
                done=(step_out.terminated | step_out.truncated),
                terminated=step_out.terminated,
                log_prob=log_prob,
                value=value,
                success=step_out.info["is_success"],
            )
            return (next_state, step_out.obs), transition

        key, k_roll, k_perm = jax.random.split(ts.key, 3)
        step_keys = jax.random.split(k_roll, cfg.rollout_steps)
        # unroll=2 stays until a card measurement decides it.
        (env_state, obs), traj = jax.lax.scan(
            rollout_step, (ts.env_state, ts.obs), step_keys, unroll=2
        )

        params, opt_state, losses, auxes = self.update_from_traj(
            ts.params, ts.opt_state, traj, obs, k_perm
        )

        metrics = {
            "loss": losses.mean(),
            "pg_loss": auxes["pg_loss"].mean(),
            "v_loss": auxes["v_loss"].mean(),
            "entropy": auxes["entropy"].mean(),
            "mean_reward": traj["reward"].mean(),
            "success_rate": traj["success"].mean(),
            "episodes": traj["done"].sum(),
        }
        new_ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=key,
            update_count=ts.update_count + 1,
        )
        return new_ts, metrics

    def update_from_traj(self, params, opt_state, traj, last_obs, key):
        """The full post-rollout update: bootstrap value, GAE, flatten,
        advantage normalization, minibatched clipped-surrogate epochs.

        THE production update - _train_step_impl calls it, and
        scripts/bench_ppo.py times this exact callable so the recorded
        "update only" cost is the program users run, not a lookalike.
        traj: dict of (T, B, ...) arrays with keys obs/raw_action/reward/
        done/log_prob/value. Returns (params, opt_state, losses, auxes).
        """
        cfg = self.config

        # Bootstrap value for the final observation.
        if self.discrete:
            _, last_value = self.network.apply(params, last_obs)
        else:
            _, _, last_value = self.network.apply(params, last_obs)

        # GAE (reverse scan). Episodes auto-reset, so done masks bootstrap.
        def gae_step(carry, t):
            gae, next_value = carry
            delta = (
                traj["reward"][t]
                + cfg.gamma * next_value * (1.0 - traj["done"][t])
                - traj["value"][t]
            )
            gae = delta + cfg.gamma * cfg.gae_lambda * (1.0 - traj["done"][t]) * gae
            return (gae, traj["value"][t]), gae

        T = cfg.rollout_steps
        (_, _), advantages = jax.lax.scan(
            gae_step,
            (jnp.zeros_like(last_value), last_value),
            jnp.arange(T - 1, -1, -1),
        )
        advantages = advantages[::-1]
        returns = advantages + traj["value"]

        # Flatten (T, B, ...) -> (T*B, ...).
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        batch = dict(
            obs=flat(traj["obs"]),
            raw_action=flat(traj["raw_action"]),
            log_prob=flat(traj["log_prob"]),
            value=flat(traj["value"]),
            advantage=flat(advantages),
            ret=flat(returns),
        )
        n = batch["log_prob"].shape[0]
        adv = batch["advantage"]
        batch["advantage"] = (adv - adv.mean()) / (adv.std() + 1e-8)

        def loss_fn(params, mb):
            log_prob, entropy, value = self._evaluate_actions(
                params, mb["obs"], mb["raw_action"]
            )
            ratio = jnp.exp(log_prob - mb["log_prob"])
            pg1 = ratio * mb["advantage"]
            pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * mb["advantage"]
            pg_loss = -jnp.minimum(pg1, pg2).mean()
            v_clipped = mb["value"] + jnp.clip(
                value - mb["value"], -cfg.clip_eps, cfg.clip_eps
            )
            v_loss = 0.5 * jnp.maximum(
                (value - mb["ret"]) ** 2, (v_clipped - mb["ret"]) ** 2
            ).mean()
            ent = entropy.mean()
            total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
            return total, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

        def epoch_step(carry, epoch_key):
            params, opt_state = carry
            perm = jax.random.permutation(epoch_key, n)

            def mb_step(carry, mb_idx):
                params, opt_state = carry
                idx = jax.lax.dynamic_slice_in_dim(
                    perm, mb_idx * (n // cfg.num_minibatches), n // cfg.num_minibatches
                )
                mb = jax.tree.map(lambda x: x[idx], batch)
                (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, mb
                )
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), (loss, aux)

            (params, opt_state), (losses, auxes) = jax.lax.scan(
                mb_step, (params, opt_state), jnp.arange(cfg.num_minibatches)
            )
            return (params, opt_state), (losses, auxes)

        epoch_keys = jax.random.split(key, cfg.num_epochs)
        (params, opt_state), (losses, auxes) = jax.lax.scan(
            epoch_step, (params, opt_state), epoch_keys
        )
        return params, opt_state, losses, auxes

    def train_step(self, ts: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
        return self._train_step(ts)

    def train(
        self,
        total_timesteps: int,
        seed: int = 0,
        log_every: int = 10,
        callback: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """Host training loop; returns final state + summary (steps/s etc.)."""
        ts = self.init(jax.random.PRNGKey(seed))
        steps_per_update = self.config.rollout_steps * self.env.batch_size
        num_updates = max(1, total_timesteps // steps_per_update)
        t0 = time.perf_counter()
        metrics = {}
        for i in range(num_updates):
            ts, metrics = self.train_step(ts)
            if callback is not None and (i % log_every == 0 or i == num_updates - 1):
                callback(i, {k: float(np.asarray(v)) for k, v in metrics.items()})
        jax.block_until_ready(ts.params)
        elapsed = time.perf_counter() - t0
        summary = {
            "updates": num_updates,
            "timesteps": num_updates * steps_per_update,
            "elapsed_s": elapsed,
            "steps_per_s": num_updates * steps_per_update / elapsed,
            **{k: float(np.asarray(v)) for k, v in metrics.items()},
        }
        return ts, summary
