"""Vectorized SpinTorque environment: SpinTorque-v0 on the accelerator.

Functional counterpart of the reference's main Gymnasium environment
(spin_torque_gym/envs/spin_torque_env.py:26-745). The entire step -
action decode, safety clamping, ~1000-substep LLGS pulse integration, energy
accounting, observation, composite reward, termination and auto-reset - is
one jit-compiled program over a batch of B independent devices. The batch
axis shards over a device mesh with zero collectives (each env independent).

Semantics parity map (reference -> here):
  * action clamp: SafetyWrapper +-1e8 A/m2, dt in [1e-12, 1e-6]
    (monitoring.py:281-315) then _parse_action clip to +-max_current,
    [1e-12, max_duration] (spin_torque_env.py:429-433) -> single fused clip
  * discrete actions: 5 currents x 4 durations (spin_torque_env.py:218-222)
  * dynamics: RobustLLGSSolver('rk4') -> integrate_pulse (parity-tested)
  * energy: E = J^2 A^2 R dt at pre-step resistance (:473-480)
  * observation: 12-dim vector / dict (:490-539), computed post-increment -
    WITHOUT the reference's stale-observation cache bug (:493-498)
  * reward: default composite success/energy/progress/stability (:184-207)
  * termination: success; truncation: step >= max_steps (:370-372)
  * reset: m ~ normal(0,1,3) normalized, target sampled from target_states
    (:286-299)
  * auto-reset (vectorized addition): done envs re-reset on-device; step
    returns the *reset* observation for done envs (gymnax convention) with
    the final observation available in info.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..devices import DeviceParams, make_device_params
from ..devices.resistance import pulse_energy as _pulse_energy
from ..devices.resistance import resistance as _resistance
from ..physics.integrator import IntegratorConfig, integrate_pulse, max_substeps_for
from ..rewards import CompositeReward, RewardContext, default_reward_config


class SpinTorqueEnvConfig(NamedTuple):
    """Static environment configuration (hashable; ctor args mirror
    spin_torque_env.py:36-53)."""

    device_type: str = "stt_mram"
    max_steps: int = 100
    max_current: float = 2e6  # A/m^2
    max_duration: float = 5e-9  # s
    temperature: float = 300.0  # K
    include_thermal: bool = True
    action_mode: str = "continuous"  # 'continuous' | 'discrete'
    observation_mode: str = "vector"  # 'vector' | 'dict'
    success_threshold: float = 0.9
    energy_penalty_weight: float = 0.1
    method: str = "rk4"
    max_substeps: int = 0  # 0 -> derived from max_duration
    noise_mode: str = "reference"
    # RK4 thermal-field sampling. The env default is 'per_substep': one
    # field realization held constant across the four stages — the standard
    # SDE discretization (stochastic Heun already works this way) and a
    # quarter of the sampling work. The reference instead draws fresh noise at every RHS
    # evaluation, which deflates the effective per-substep field variance to
    # 10/36 (the squared RK4 weights average the iid draws) — a physics bug
    # we deliberately do NOT replicate by default, like the broken discrete
    # mode (docs/REFERENCE_PARITY.md). Set 'per_stage' to reproduce the
    # reference's sampling exactly; the library-level IntegratorConfig
    # default remains 'per_stage' for parity work.
    rk4_noise: str = "per_substep"
    autoreset: bool = True
    dtype: str = "float32"
    # Fused GPU pulse kernel. None = chosen by platform at env build: on a
    # GPU when the kernel covers the configuration, XLA elsewhere. True
    # insists (raises where the kernel cannot run); False keeps XLA.
    use_pallas: bool | None = None

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def resolved_max_substeps(self) -> int:
        if self.max_substeps:
            return self.max_substeps
        return max_substeps_for(self.max_duration)

    def integrator(self) -> IntegratorConfig:
        return IntegratorConfig(
            method=self.method,
            max_step=1e-12,
            max_substeps=self.resolved_max_substeps(),
            thermal=self.include_thermal,
            noise_mode=self.noise_mode,
            use_pallas=self.use_pallas,
            rk4_noise=self.rk4_noise,
        )


@struct.dataclass
class EnvState:
    """Batched environment state pytree (replaces the per-env Python object
    state at spin_torque_env.py:133-149)."""

    m: Any  # (B, 3) magnetization
    target: Any  # (B, 3)
    step: Any  # (B,) int32
    total_energy: Any  # (B,)
    last_current: Any  # (B,)
    last_duration: Any  # (B,)
    episode_return: Any  # (B,) running sum of rewards (monitoring)
    key: Any  # (2,) PRNG key driving reset sampling + thermal noise
    reward_stats: Dict[str, Any] = struct.field(default_factory=dict)


class TimeStep(NamedTuple):
    obs: Any  # (B, obs_dim) or dict of arrays
    reward: Any  # (B,)
    terminated: Any  # (B,) bool
    truncated: Any  # (B,) bool
    info: Dict[str, Any]


# Discrete action tables (spin_torque_env.py:218-222).
_N_DURATIONS = 4
_DURATION_LEVELS = (0.1e-9, 0.5e-9, 1.0e-9, 2.0e-9)
_N_CURRENTS = 5


class SpinTorqueEnv:
    """Vectorized spin-torque device control environment.

    Usage (functional API):
        env = SpinTorqueEnv(batch_size=4096)
        state, obs = env.reset(jax.random.PRNGKey(0))
        state, ts = env.step(state, actions)   # jitted end-to-end

    Gymnasium adapters live in envs/gym_adapter.py.
    """

    def __init__(
        self,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[SpinTorqueEnvConfig] = None,
        mesh=None,
        **config_overrides,
    ):
        if config is None:
            config = SpinTorqueEnvConfig(device_type=device_type, **config_overrides)
        self.config = config
        self.batch_size = batch_size
        # Multi-device: when the env batch is sharded over mesh's 'data'
        # axis, the GPU kernel runs PER SHARD (shard_map), so no batch data
        # crosses devices in the hot loop.
        # ``mesh`` rides through step() as a static jit argument, so setting
        # env.mesh later (before more steps) retraces correctly.
        self.mesh = mesh
        dtype = config.jnp_dtype

        self.device_params: DeviceParams = make_device_params(
            config.device_type, device_params, dtype=dtype
        )

        if target_states is None:
            targets = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
        else:
            targets = np.stack([np.asarray(t, float) for t in target_states])
            targets = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
        self.target_states = jnp.asarray(targets, dtype)  # (K, 3)

        if config.use_pallas is None or config.use_pallas:
            # Resolve the kernel flag here, where parameters are concrete
            # (inside jit they are tracers). The kernel's thermal stream is
            # its own counter-based generator: a different realization from
            # the XLA path's, with the same statistics (thermal mode has no
            # parity contract).
            from ..ops.pallas_integrator import pallas_supported, select_kernel

            supported = pallas_supported(
                self.device_params.llgs(),
                config.integrator()._replace(use_pallas=False),
                dtype,
            )
            config = config._replace(
                use_pallas=select_kernel(config.use_pallas, supported)
            )
            self.config = config

        if reward_components is None:
            reward_components = default_reward_config(
                config.energy_penalty_weight, config.observation_mode
            )
        self.reward = CompositeReward(reward_components)

        # Jitted entry points. State is deliberately NOT donated: donation
        # breaks when callers alias state fields (e.g. m=target), and the
        # state is far too small for the copy to matter.
        self._step = jax.jit(self._step_impl, static_argnames=("mesh",))
        self._reset = jax.jit(self._reset_impl)
        self._observe_jit = jax.jit(self._observe)

    # ------------------------------------------------------------------ API

    def reset(self, key: jax.Array) -> Tuple[EnvState, Any]:
        state = self._reset(key)
        return state, self._observe_jit(state)

    def observe(self, state: EnvState):
        """Jitted observation of an arbitrary state (used by adapters after
        host-side state overrides)."""
        return self._observe_jit(state)

    def step(self, state: EnvState, action) -> Tuple[EnvState, TimeStep]:
        return self._step(state, action, mesh=self.mesh)

    @property
    def observation_size(self) -> int:
        return 12

    @property
    def action_size(self) -> int:
        return 2 if self.config.action_mode == "continuous" else 1

    @property
    def num_actions(self) -> int:
        return _N_CURRENTS * _N_DURATIONS

    # ------------------------------------------------------------- internals

    def _sample_m(self, key, batch) -> jnp.ndarray:
        """Random initial magnetization: normal(0,1,3) normalized
        (spin_torque_env.py:289-291)."""
        dtype = self.config.jnp_dtype
        m = jax.random.normal(key, (batch, 3), dtype)
        norm = jnp.linalg.norm(m, axis=-1, keepdims=True)
        return m / jnp.maximum(norm, 1e-12)

    def _sample_target(self, key, batch) -> jnp.ndarray:
        idx = jax.random.randint(key, (batch,), 0, self.target_states.shape[0])
        return self.target_states[idx]

    def _reset_impl(self, key: jax.Array) -> EnvState:
        dtype = self.config.jnp_dtype
        B = self.batch_size
        key, k_m, k_t = jax.random.split(key, 3)
        stats = self.reward.init_stats(B, dtype) if self.reward.needs_stats else {}
        return EnvState(
            m=self._sample_m(k_m, B),
            target=self._sample_target(k_t, B),
            step=jnp.zeros((B,), jnp.int32),
            total_energy=jnp.zeros((B,), dtype),
            last_current=jnp.zeros((B,), dtype),
            last_duration=jnp.zeros((B,), dtype),
            episode_return=jnp.zeros((B,), dtype),
            key=key,
            reward_stats=stats,
        )

    def _decode_action(self, action) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Action -> (J, duration) with safety clamps
        (spin_torque_env.py:409-433 + monitoring.py:288-315)."""
        cfg = self.config
        dtype = cfg.jnp_dtype
        if cfg.action_mode == "continuous":
            action = jnp.asarray(action, dtype)
            if action.ndim == 1 and self.batch_size == 1 and action.shape[0] == 2:
                # A single env given the documented [current, duration] pair.
                action = action[None, :]
            if action.ndim == 1:  # (B,) current-only -> default 1 ns
                if action.shape[0] != self.batch_size:
                    raise ValueError(
                        f"1-D continuous action of length {action.shape[0]} does "
                        f"not match batch_size {self.batch_size}; pass (B, 2) "
                        "[current, duration] actions"
                    )
                current = action
                duration = jnp.full_like(current, 1e-9)
            else:
                current = action[..., 0]
                duration = action[..., 1]
            # NaN/Inf scrub (SafetyWrapper): invalid -> (0, 1e-12).
            bad = ~(jnp.isfinite(current) & jnp.isfinite(duration))
            current = jnp.where(bad, 0.0, current)
            duration = jnp.where(bad, 1e-12, duration)
        else:
            idx = jnp.asarray(action, jnp.int32).reshape(-1)
            current_idx = idx // _N_DURATIONS
            duration_idx = idx % _N_DURATIONS
            levels = jnp.linspace(-cfg.max_current, cfg.max_current, _N_CURRENTS,
                                  dtype=dtype)
            durations = jnp.asarray(_DURATION_LEVELS, dtype)
            current = levels[jnp.clip(current_idx, 0, _N_CURRENTS - 1)]
            duration = durations[jnp.clip(duration_idx, 0, _N_DURATIONS - 1)]
        current = jnp.clip(current, -cfg.max_current, cfg.max_current)
        duration = jnp.clip(duration, 1e-12, cfg.max_duration)
        return current, duration

    def _resistance(self, m: jnp.ndarray) -> jnp.ndarray:
        return _resistance(
            self.config.device_type, m[..., 0], m[..., 1], m[..., 2],
            self.device_params,
        )

    def _observe(self, state: EnvState):
        """Observation (spin_torque_env.py:490-539), no caching bug."""
        cfg = self.config
        dtype = cfg.jnp_dtype
        r = self._resistance(state.m)
        if cfg.observation_mode == "vector":
            r0 = self.device_params.resistance_parallel
            obs = jnp.concatenate(
                [
                    state.m,
                    state.target,
                    (r / r0)[..., None],
                    jnp.full_like(r, cfg.temperature / 300.0)[..., None],
                    ((cfg.max_steps - state.step) / cfg.max_steps).astype(dtype)[..., None],
                    (state.total_energy / 1e-12)[..., None],
                    (state.last_current / cfg.max_current)[..., None],
                    (state.last_duration / cfg.max_duration)[..., None],
                ],
                axis=-1,
            )
            return obs
        return {
            "magnetization": state.m,
            "target": state.target,
            "resistance": r[..., None],
            "temperature": jnp.full_like(r, cfg.temperature)[..., None],
            "steps_remaining": (cfg.max_steps - state.step)[..., None],
            "energy_consumed": state.total_energy[..., None],
            "last_action": jnp.stack([state.last_current, state.last_duration], -1),
        }

    def _step_impl(
        self, state: EnvState, action, mesh=None
    ) -> Tuple[EnvState, TimeStep]:
        cfg = self.config
        dtype = cfg.jnp_dtype
        B = self.batch_size
        mesh = mesh if mesh is not None else self.mesh

        key, k_noise, k_m, k_t = jax.random.split(state.key, 4)

        current, duration = self._decode_action(action)

        m_prev = state.m
        prev_alignment = jnp.sum(m_prev * state.target, axis=-1)

        # --- dynamics: one fused pulse integration over the batch ---
        res = integrate_pulse(
            (m_prev[:, 0], m_prev[:, 1], m_prev[:, 2]),
            span=duration,
            current=current,
            params=self.device_params.llgs(),
            config=cfg.integrator(),
            key=k_noise,
            temperature=jnp.asarray(cfg.temperature, dtype),
            mesh=mesh,
        )
        mx, my, mz = res.m
        # Final renormalization (spin_torque_env.py:462-464)...
        norm = jnp.sqrt(mx * mx + my * my + mz * mz)
        m_int = jnp.stack([mx / norm, my / norm, mz / norm], axis=-1)
        # ...unless the solve "failed" (zero trajectory row), in which case
        # the reference keeps the pre-step state untouched - no renormalize
        # (spin_torque_env.py:461-467; see PulseResult.failed for the full
        # reference bug chain being reproduced here).
        m_new = jnp.where(res.failed[:, None], m_prev, m_int)

        # --- energy at PRE-step resistance (spin_torque_env.py:473-480) ---
        r_pre = self._resistance(m_prev)
        step_energy = _pulse_energy(current, duration, r_pre, self.device_params.area)

        total_energy = state.total_energy + step_energy
        step = state.step + 1

        alignment = jnp.sum(m_new * state.target, axis=-1)
        improvement = alignment - prev_alignment
        is_success = alignment >= cfg.success_threshold

        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        mid_state = state.replace(
            m=m_new,
            step=step,
            total_energy=total_energy,
            last_current=current,
            last_duration=duration,
            key=key,
        )
        obs_step = self._observe(mid_state)

        # --- reward (spin_torque_env.py:349-368) ---
        ctx = RewardContext(
            is_success=is_success,
            step_energy=step_energy,
            alignment=alignment,
            alignment_improvement=improvement,
            magnetization_norm=jnp.linalg.norm(m_new, axis=-1),
            step_count=step,
            total_energy=total_energy,
            action_current=current,
            action_duration=duration,
        )
        reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
        # SafetyWrapper reward clamp (monitoring.py:333-348).
        reward = jnp.clip(jnp.nan_to_num(reward, nan=-1.0), -1e6, 1e6)
        episode_return = state.episode_return + reward

        info: Dict[str, Any] = {
            "step_count": step,
            "total_energy": total_energy,
            "current_alignment": alignment,
            "is_success": is_success,
            "target_reached": is_success,
            "step_energy": step_energy,
            "alignment_improvement": improvement,
            "pulse_duration": duration,
            "current_density": current,
            "magnetization_magnitude": jnp.linalg.norm(m_new, axis=-1),
            "episode_return": episode_return,
            "reward_components": breakdown,
            "final_magnetization": m_new,
            "simulation_success": ~res.failed,
        }

        if cfg.autoreset:
            # On-device auto-reset of done envs (replaces the host reset
            # round-trip; lax.select keeps everything fused).
            m_reset = self._sample_m(k_m, B)
            t_reset = self._sample_target(k_t, B)
            d3 = done[:, None]
            zero = jnp.zeros((B,), dtype)
            next_state = mid_state.replace(
                m=jnp.where(d3, m_reset, m_new),
                target=jnp.where(d3, t_reset, state.target),
                step=jnp.where(done, 0, step),
                total_energy=jnp.where(done, zero, total_energy),
                last_current=jnp.where(done, zero, current),
                last_duration=jnp.where(done, zero, duration),
                episode_return=jnp.where(done, zero, episode_return),
                reward_stats=new_stats,
            )
            obs_reset = self._observe(next_state)
            if cfg.observation_mode == "vector":
                obs = jnp.where(done[:, None], obs_reset, obs_step)
            else:
                obs = jax.tree.map(
                    lambda a, b: jnp.where(
                        done.reshape((B,) + (1,) * (a.ndim - 1)), a, b
                    ),
                    obs_reset,
                    obs_step,
                )
            info["final_observation"] = obs_step
        else:
            next_state = mid_state.replace(
                episode_return=episode_return, reward_stats=new_stats
            )
            obs = obs_step

        return next_state, TimeStep(
            obs=obs,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info=info,
        )
