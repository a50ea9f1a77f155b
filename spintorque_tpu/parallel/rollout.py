"""Device-resident rollout collection.

Replaces the reference's host-side episode loops (cli.py train/eval,
utils/concurrency.py AsyncEnvironmentManager) with a single jitted
``lax.scan`` over env steps: policy forward + env transition stay on device
for the whole horizon; only the final stacked trajectory (or its summary
statistics) crosses back to the host. Under a sharded mesh the env batch
axis lives on 'data' and the scan runs SPMD with zero collectives; metric
reduction is one psum at the end.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..envs.spin_torque import EnvState, SpinTorqueEnv


class Trajectory(NamedTuple):
    obs: Any  # (T, B, obs_dim)
    action: Any  # (T, B, act_dim) or (T, B)
    reward: Any  # (T, B)
    terminated: Any  # (T, B)
    truncated: Any  # (T, B)
    log_prob: Any  # (T, B) (zeros when policy provides none)
    value: Any  # (T, B) (zeros when policy provides none)
    info: Dict[str, Any]  # selected per-step metrics, each (T, B)

_INFO_KEYS = ("is_success", "step_energy", "current_alignment", "episode_return")


def rollout(
    env: SpinTorqueEnv,
    policy_fn: Callable,
    policy_params: Any,
    state: EnvState,
    obs: Any,
    key: jax.Array,
    num_steps: int,
) -> Tuple[EnvState, Any, Trajectory]:
    """Collect ``num_steps`` transitions fully on device.

    policy_fn(params, obs, key) must return either
      actions                       - plain actors, random policies
      (actions, log_prob, value)    - actor-critic (PPO) policies
    """
    def step_fn(carry, step_key):
        state, obs = carry
        out = policy_fn(policy_params, obs, step_key)
        if isinstance(out, tuple):
            action, log_prob, value = out
        else:
            action, log_prob, value = out, None, None
        next_state, ts = env._step_impl(state, action)
        zeros = jnp.zeros_like(ts.reward)
        record = Trajectory(
            obs=obs,
            action=action,
            reward=ts.reward,
            terminated=ts.terminated,
            truncated=ts.truncated,
            log_prob=zeros if log_prob is None else log_prob,
            value=zeros if value is None else value,
            info={k: ts.info[k] for k in _INFO_KEYS},
        )
        return (next_state, ts.obs), record

    keys = jax.random.split(key, num_steps)
    # unroll=2 stays until a card measurement decides it.
    (state, obs), traj = jax.lax.scan(step_fn, (state, obs), keys, unroll=2)
    return state, obs, traj


def rollout_jit(env: SpinTorqueEnv, policy_fn: Callable, num_steps: int):
    """Build a jitted rollout closure for a fixed env/policy/horizon."""
    fn = partial(rollout, env, policy_fn)

    @jax.jit
    def run(policy_params, state, obs, key):
        return fn(policy_params, state, obs, key, num_steps)

    return run


def summarize(traj: Trajectory) -> Dict[str, jnp.ndarray]:
    """Scalar rollout metrics (one cross-chip reduction under sharding)."""
    done = traj.terminated | traj.truncated
    episodes = jnp.maximum(done.sum(), 1)
    return {
        "steps": jnp.asarray(traj.reward.size),
        "mean_reward": traj.reward.mean(),
        "episodes": done.sum(),
        "success_rate": jnp.where(
            done.any(), (traj.terminated & done).sum() / episodes, 0.0
        ),
        "mean_step_energy": traj.info["step_energy"].mean(),
        "mean_alignment": traj.info["current_alignment"].mean(),
    }


def random_policy(env: SpinTorqueEnv):
    """Uniform random policy over the env's action space (eval/bench)."""
    cfg = env.config

    def policy(params, obs, key):
        del params
        B = obs.shape[0] if not isinstance(obs, dict) else next(iter(obs.values())).shape[0]
        if cfg.action_mode == "continuous":
            kj, kd = jax.random.split(key)
            current = jax.random.uniform(
                kj, (B,), cfg.jnp_dtype, -cfg.max_current, cfg.max_current
            )
            duration = jax.random.uniform(
                kd, (B,), cfg.jnp_dtype, 1e-12, cfg.max_duration
            )
            return jnp.stack([current, duration], axis=-1)
        return jax.random.randint(key, (B,), 0, env.num_actions)

    return policy
