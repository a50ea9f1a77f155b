"""Vectorized skyrmion racetrack environment: SkyrmionRacetrack-v0 on the accelerator.

Functional counterpart of the reference SkyrmionRacetrackEnv
(spin_torque_gym/envs/skyrmion_env.py:20-870). A batch of B racetracks, each
carrying n point-particle skyrmions, advances in one jitted program; the
per-skyrmion force assembly and the 10-substep damped-inertia Euler
integration with reflecting boundaries (:475-566) become fused (B, n, 2)
vector ops.

Reference semantics preserved:
  * fixed 20 degree Hall angle, magnus coefficient 4 pi Ms (:490-492)
  * drive force = SHA * |J|, magnus = drive * tan(20deg) perpendicular
  * gradient force scale 1e-24 (:510-512)
  * exponential pinning wells along the track centerline (:566-588)
  * thermal kick sqrt(2 k_B T / (r * 1e-9)) in a random direction per step
    (:590-600), threefry-keyed here
  * boundary clip + inelastic velocity reflection (vel *= -0.5) (:541-550)
  * stability = exp(-|v|/50), resistive pulse energy (:552-564)
  * rewards positioning/energy/velocity/stability/efficiency (:185-252)
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..constants import KB_SOLVER
from ..rewards import CompositeReward, RewardContext

_HALL_ANGLE = math.radians(20.0)  # skyrmion_env.py:490


class SkyrmionEnvConfig(NamedTuple):
    """Static configuration (ctor args mirror skyrmion_env.py:31-52)."""

    track_length: float = 1000e-9
    track_width: float = 200e-9
    track_thickness: float = 2e-9
    n_skyrmions: int = 1
    skyrmion_radius: float = 20e-9
    max_steps: int = 150
    max_current: float = 1e12
    max_gradient: float = 1e18
    temperature: float = 300.0
    include_thermal: bool = True
    include_pinning: bool = True
    pinning_strength: float = 0.1
    action_mode: str = "continuous"  # 'continuous' | 'discrete'
    observation_mode: str = "vector"  # 'vector' | 'dict'
    success_threshold: float = 10e-9
    energy_penalty_weight: float = 0.1
    autoreset: bool = True
    dtype: str = "float32"
    # Racetrack material (skyrmion_env.py:157-171 defaults)
    saturation_magnetization: float = 580e3
    damping: float = 0.3
    spin_hall_angle: float = 0.1
    resistivity: float = 2e-7

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


@struct.dataclass
class SkyrmionEnvState:
    positions: Any  # (B, n, 2)
    velocities: Any  # (B, n, 2)
    step: Any  # (B,) int32
    total_energy: Any  # (B,)
    episode_return: Any  # (B,)
    key: Any
    reward_stats: Dict[str, Any] = struct.field(default_factory=dict)


class SkyrmionTimeStep(NamedTuple):
    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: Dict[str, Any]


# Discrete action tables (skyrmion_env.py:265-276).
_DIRECTIONS = np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [0, 0]], float)
_N_GRADIENTS = 3
_N_DURATIONS = 3
_DURATION_LEVELS = (0.1e-9, 0.5e-9, 1.0e-9)


def _default_reward_config(cfg: SkyrmionEnvConfig) -> Dict[str, Dict]:
    """Default components (skyrmion_env.py:185-252)."""

    def positioning(ctx: RewardContext):
        errors = ctx.extras["position_errors"]  # (B, n)
        per = jnp.where(
            errors < cfg.success_threshold,
            10.0,
            jnp.maximum(0.0, 5.0 * (1.0 - errors / (cfg.track_length * 0.1))),
        )
        return per.mean(-1)

    def energy(ctx: RewardContext):
        return -ctx.step_energy / 1e-15  # fJ normalization

    def velocity(ctx: RewardContext):
        vmag = ctx.extras["velocity_magnitudes"]  # (B, n)
        return jnp.where(vmag > 100.0, (vmag - 100.0) / 100.0, 0.0).sum(-1)

    def stability(ctx: RewardContext):
        return ctx.extras["stability_factors"].mean(-1)

    def efficiency(ctx: RewardContext):
        disp = ctx.extras["total_displacement"]
        e = ctx.step_energy
        eff = jnp.minimum(disp / (e / 1e-15), 10.0)
        return jnp.where(e > 0, eff, 0.0)

    return {
        "positioning": {"weight": 10.0, "function": positioning},
        "energy": {"weight": -cfg.energy_penalty_weight, "function": energy},
        "velocity": {"weight": -1.0, "function": velocity},
        "stability": {"weight": 5.0, "function": stability},
        "efficiency": {"weight": 2.0, "function": efficiency},
    }


class SkyrmionRacetrackEnv:
    """Vectorized skyrmion racetrack environment (functional API)."""

    def __init__(
        self,
        target_positions: Optional[List[float]] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[SkyrmionEnvConfig] = None,
        seed: int = 0,
        **config_overrides,
    ):
        if config is None:
            config = SkyrmionEnvConfig(**config_overrides)
        self.config = config
        self.batch_size = batch_size
        dtype = config.jnp_dtype
        n = config.n_skyrmions

        if target_positions is None:
            targets = np.linspace(
                config.track_length * 0.2, config.track_length * 0.8, n
            )
        else:
            if len(target_positions) != n:
                raise ValueError(
                    "Number of target positions must match number of skyrmions"
                )
            targets = np.asarray(target_positions, float)
        self.target_x = jnp.asarray(targets, dtype)  # (n,)

        # Pinning sites: random along the track, ~1 per 20 radii, fixed per
        # env instance (skyrmion_env.py:173-183) - here shared across the
        # batch and generated from the construction seed.
        rng = np.random.default_rng(seed)
        n_sites = int(config.track_length / (20 * config.skyrmion_radius))
        n_sites = max(n_sites, 1) if config.include_pinning else 0
        self.pin_x = jnp.asarray(
            rng.uniform(0, config.track_length, n_sites), dtype
        )
        self.pin_strength = jnp.asarray(
            rng.uniform(0.5, 2.0, n_sites) * config.pinning_strength, dtype
        )

        if reward_components is None:
            reward_components = _default_reward_config(config)
        self.reward = CompositeReward(reward_components)

        self._step = jax.jit(self._step_impl)
        self._reset = jax.jit(self._reset_impl)
        self._observe_jit = jax.jit(self._observe)

    # ------------------------------------------------------------------ API

    def reset(self, key: jax.Array):
        state = self._reset(key)
        return state, self._observe_jit(state)

    def step(self, state: SkyrmionEnvState, action):
        return self._step(state, action)

    def observe(self, state: SkyrmionEnvState):
        return self._observe_jit(state)

    def set_targets(self, target_x) -> None:
        """Replace the per-skyrmion target x-positions.

        Targets are closure constants of the jitted step/observe programs,
        so the jit wrappers are rebuilt here; stale-constant reuse was a
        silent-wrong-answer bug (review finding)."""
        self.target_x = jnp.asarray(
            np.asarray(target_x, float), self.config.jnp_dtype
        )
        self._step = jax.jit(self._step_impl)
        self._reset = jax.jit(self._reset_impl)
        self._observe_jit = jax.jit(self._observe)

    @property
    def num_actions(self) -> int:
        return len(_DIRECTIONS) * _N_GRADIENTS * _N_DURATIONS  # 45

    # ------------------------------------------------------------- internals

    def _reset_impl(self, key: jax.Array) -> SkyrmionEnvState:
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, n = self.batch_size, cfg.n_skyrmions
        key, k_x = jax.random.split(key)
        x = jax.random.uniform(
            k_x, (B, n), dtype,
            cfg.skyrmion_radius, cfg.track_length - cfg.skyrmion_radius,
        )
        y = jnp.full((B, n), cfg.track_width / 2.0, dtype)
        stats = self.reward.init_stats(B, dtype) if self.reward.needs_stats else {}
        return SkyrmionEnvState(
            positions=jnp.stack([x, y], axis=-1),
            velocities=jnp.zeros((B, n, 2), dtype),
            step=jnp.zeros((B,), jnp.int32),
            total_energy=jnp.zeros((B,), dtype),
            episode_return=jnp.zeros((B,), dtype),
            key=key,
            reward_stats=stats,
        )

    def _decode_action(self, action):
        """-> (jx, jy, gx, gy, duration), each (B,)
        (skyrmion_env.py:414-451)."""
        cfg = self.config
        dtype = cfg.jnp_dtype
        if cfg.action_mode == "continuous":
            a = jnp.asarray(action, dtype)
            if a.ndim == 1:
                a = a[None, :]
            jx, jy = a[:, 0], a[:, 1]
            gx = a[:, 2] if a.shape[1] > 2 else jnp.zeros_like(jx)
            gy = a[:, 3] if a.shape[1] > 3 else jnp.zeros_like(jx)
            dur = a[:, 4] if a.shape[1] > 4 else jnp.full_like(jx, 1e-9)
        else:
            idx = jnp.asarray(action, jnp.int32).reshape(-1)
            dir_idx = idx // (_N_GRADIENTS * _N_DURATIONS)
            grad_idx = (idx // _N_DURATIONS) % _N_GRADIENTS
            dur_idx = idx % _N_DURATIONS
            dirs = jnp.asarray(_DIRECTIONS, dtype)
            grads = jnp.asarray(
                [0.0, cfg.max_gradient * 0.5, cfg.max_gradient], dtype
            )
            durs = jnp.asarray(_DURATION_LEVELS, dtype)
            d = dirs[jnp.clip(dir_idx, 0, len(_DIRECTIONS) - 1)]
            jx = d[:, 0] * cfg.max_current * 0.5
            jy = d[:, 1] * cfg.max_current * 0.5
            gx = grads[jnp.clip(grad_idx, 0, _N_GRADIENTS - 1)]
            gy = jnp.zeros_like(gx)
            dur = durs[jnp.clip(dur_idx, 0, _N_DURATIONS - 1)]
        jx = jnp.clip(jx, -cfg.max_current, cfg.max_current)
        jy = jnp.clip(jy, -cfg.max_current, cfg.max_current)
        gx = jnp.clip(gx, -cfg.max_gradient, cfg.max_gradient)
        gy = jnp.clip(gy, -cfg.max_gradient, cfg.max_gradient)
        dur = jnp.clip(dur, 1e-12, 2e-9)
        return jx, jy, gx, gy, dur

    def _pinning_force(self, positions):
        """Exponential wells along the centerline (skyrmion_env.py:566-588).
        positions: (B, n, 2) -> force (B, n, 2)."""
        cfg = self.config
        if self.pin_x.shape[0] == 0 or not cfg.include_pinning:
            return jnp.zeros_like(positions)
        site = jnp.stack(
            [self.pin_x, jnp.full_like(self.pin_x, cfg.track_width / 2.0)], -1
        )  # (S, 2)
        dvec = positions[:, :, None, :] - site[None, None, :, :]  # (B,n,S,2)
        dist = jnp.linalg.norm(dvec, axis=-1)  # (B,n,S)
        in_range = dist < 3.0 * cfg.skyrmion_radius
        mag = self.pin_strength * jnp.exp(-dist / cfg.skyrmion_radius)
        safe = jnp.maximum(dist, 1e-30)
        force = -(mag * in_range / safe)[..., None] * dvec
        return force.sum(axis=2)

    def _position_errors(self, positions):
        cfg = self.config
        target = jnp.stack(
            [self.target_x, jnp.full_like(self.target_x, cfg.track_width / 2.0)],
            -1,
        )  # (n, 2)
        return jnp.linalg.norm(positions - target[None, :, :], axis=-1)  # (B,n)

    def _observe(self, state: SkyrmionEnvState):
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, n = state.positions.shape[0], cfg.n_skyrmions
        errors = self._position_errors(state.positions)
        if cfg.observation_mode == "vector":
            targets = jnp.stack(
                [self.target_x, jnp.full_like(self.target_x, cfg.track_width / 2.0)],
                -1,
            )
            vel_mag = jnp.linalg.norm(state.velocities, axis=-1)
            return jnp.concatenate(
                [
                    state.positions.reshape(B, -1) / cfg.track_length,
                    state.velocities.reshape(B, -1) / 100.0,
                    jnp.broadcast_to(targets.reshape(-1), (B, 2 * n)) / cfg.track_length,
                    ((cfg.max_steps - state.step) / cfg.max_steps).astype(dtype)[:, None],
                    (state.total_energy / 1e-15)[:, None],
                    (errors.mean(-1) / (cfg.track_length * 0.1))[:, None],
                    (vel_mag.mean(-1) / 100.0)[:, None],
                ],
                axis=-1,
            )
        return {
            "positions": state.positions,
            "velocities": state.velocities,
            "target_positions": jnp.broadcast_to(self.target_x, (B, n)),
            "position_errors": errors,
            "steps_remaining": (cfg.max_steps - state.step)[:, None],
            "total_energy": state.total_energy[:, None],
        }

    def _step_impl(self, state: SkyrmionEnvState, action, mesh=None):
        # ``mesh`` accepted for step-API uniformity with SpinTorqueEnv
        # (measurement/rollout harnesses pass it); this env's dynamics
        # are plain XLA elementwise ops that auto-partition without it.
        del mesh
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, n = self.batch_size, cfg.n_skyrmions

        key, k_thermal, k_reset = jax.random.split(state.key, 3)
        jx, jy, gx, gy, dur = self._decode_action(action)

        prev_pos = state.positions
        prev_errors = self._position_errors(prev_pos)

        # ---- force assembly (skyrmion_env.py:488-525), (B, n, 2) ----
        j_mag = jnp.sqrt(jx * jx + jy * jy)  # (B,)
        safe_j = jnp.maximum(j_mag, 1e-300 if dtype == jnp.float64 else 1e-30)
        dir_x, dir_y = jx / safe_j, jy / safe_j
        f_drive = cfg.spin_hall_angle * j_mag
        f_magnus = f_drive * math.tan(_HALL_ANGLE)
        fx = f_drive * dir_x + f_magnus * (-dir_y)
        fy = f_drive * dir_y + f_magnus * dir_x
        has_j = j_mag > 0
        fx = jnp.where(has_j, fx, 0.0)
        fy = jnp.where(has_j, fy, 0.0)
        force = jnp.stack([fx, fy], -1)[:, None, :]  # (B,1,2) broadcast over n
        force = force + jnp.stack([gx, gy], -1)[:, None, :] * 1e-24
        force = jnp.broadcast_to(force, (B, n, 2))
        force = force + self._pinning_force(prev_pos)
        if cfg.include_thermal:
            # Random unit direction * thermal magnitude per skyrmion per step
            # (skyrmion_env.py:590-600).
            mag = math.sqrt(2.0 * KB_SOLVER * cfg.temperature / (cfg.skyrmion_radius * 1e-9))
            d = jax.random.normal(k_thermal, (B, n, 2), dtype)
            d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
            force = force + mag * d

        # ---- 10-substep damped-inertia Euler with reflecting walls ----
        magnus_coeff = 4.0 * math.pi * cfg.saturation_magnetization
        mass_eff = magnus_coeff * cfg.skyrmion_radius**2
        dt = (dur / 10.0)[:, None, None]
        lo_x, hi_x = cfg.skyrmion_radius, cfg.track_length - cfg.skyrmion_radius
        lo_y, hi_y = cfg.skyrmion_radius, cfg.track_width - cfg.skyrmion_radius

        pos, vel = prev_pos, state.velocities
        for _ in range(10):
            accel = force / mass_eff - cfg.damping * vel
            vel = vel + accel * dt
            pos = pos + vel * dt
            px = jnp.clip(pos[..., 0], lo_x, hi_x)
            py = jnp.clip(pos[..., 1], lo_y, hi_y)
            hit_x = (px <= lo_x) | (px >= hi_x)
            hit_y = (py <= lo_y) | (py >= hi_y)
            vx = jnp.where(hit_x, vel[..., 0] * -0.5, vel[..., 0])
            vy = jnp.where(hit_y, vel[..., 1] * -0.5, vel[..., 1])
            pos = jnp.stack([px, py], -1)
            vel = jnp.stack([vx, vy], -1)

        vel_mag = jnp.linalg.norm(vel, axis=-1)  # (B, n)
        stability = jnp.exp(-vel_mag / 50.0)

        # ---- pulse energy (skyrmion_env.py:556-564) ----
        area = cfg.track_width * cfg.track_thickness
        voltage = j_mag * cfg.resistivity * cfg.track_length / area
        e_per = voltage**2 / cfg.resistivity * dur * area / cfg.track_length
        step_energy = jnp.where(j_mag > 0, e_per, 0.0) * n  # per skyrmion sum

        displacement = jnp.linalg.norm(pos - prev_pos, axis=-1).sum(-1)  # (B,)
        total_energy = state.total_energy + step_energy
        step = state.step + 1

        errors = self._position_errors(pos)
        is_success = jnp.all(errors < cfg.success_threshold, axis=-1)
        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        mid_state = state.replace(
            positions=pos, velocities=vel, step=step,
            total_energy=total_energy, key=key,
        )
        obs_step = self._observe(mid_state)

        ctx = RewardContext(
            is_success=is_success,
            step_energy=step_energy,
            alignment=-errors.mean(-1),
            alignment_improvement=(prev_errors - errors).mean(-1),
            magnetization_norm=jnp.ones((B,), dtype),
            step_count=step,
            total_energy=total_energy,
            action_current=j_mag,
            action_duration=dur,
            extras={
                "position_errors": errors,
                "velocity_magnitudes": vel_mag,
                "stability_factors": stability,
                "total_displacement": displacement,
            },
        )
        reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
        episode_return = state.episode_return + reward

        info = {
            "step_count": step,
            "total_energy": total_energy,
            "position_errors": errors,
            "average_error": errors.mean(-1),
            "is_success": is_success,
            "step_energy": step_energy,
            "stability_factors": stability,
            "total_displacement": displacement,
            "episode_return": episode_return,
            "reward_components": breakdown,
        }

        if cfg.autoreset:
            x = jax.random.uniform(
                k_reset, (B, n), dtype,
                cfg.skyrmion_radius, cfg.track_length - cfg.skyrmion_radius,
            )
            y = jnp.full((B, n), cfg.track_width / 2.0, dtype)
            pos_reset = jnp.stack([x, y], -1)
            d2 = done[:, None, None]
            zero = jnp.zeros((B,), dtype)
            next_state = mid_state.replace(
                positions=jnp.where(d2, pos_reset, pos),
                velocities=jnp.where(d2, jnp.zeros_like(vel), vel),
                step=jnp.where(done, 0, step),
                total_energy=jnp.where(done, zero, total_energy),
                episode_return=jnp.where(done, zero, episode_return),
                reward_stats=new_stats,
            )
            obs_reset = self._observe(next_state)
            expand = lambda a: done.reshape((B,) + (1,) * (a.ndim - 1))
            if isinstance(obs_step, dict):
                obs = jax.tree.map(
                    lambda a, b: jnp.where(expand(a), a, b), obs_reset, obs_step
                )
            else:
                obs = jnp.where(expand(obs_step), obs_reset, obs_step)
            info["final_observation"] = obs_step
        else:
            next_state = mid_state.replace(
                episode_return=episode_return, reward_stats=new_stats
            )
            obs = obs_step

        return next_state, SkyrmionTimeStep(
            obs=obs, reward=reward, terminated=terminated, truncated=truncated,
            info=info,
        )
