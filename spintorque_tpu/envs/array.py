"""Vectorized crossbar array environment: SpinTorqueArray-v0 on the accelerator.

Functional counterpart of the reference SpinTorqueArrayEnv
(spin_torque_gym/envs/array_env.py:20-755). A batch of B independent N=R*C
crossbar arrays is stepped in one jitted program. Within one array the
reference updates affected devices *sequentially*, each seeing the partially
updated pattern through the coupling field (array_env.py:446-476); that
ordering is preserved with a masked ``lax.scan`` over the device index,
while the coupling sum itself is one (N,) x (B, N, 3) contraction instead of
the reference's O(N^2) Python loop (:478-495).

Reference semantics preserved deliberately (for parity):
  * the inline constant-slope 10-substep Euler with HARDCODED alpha=0.01 /
    gamma=2.21e5 and tau = 0.1 J m x (m x z) - the env never calls the
    LLGSSolver it constructs (:497-531; documented quirk)
  * zero-current actions leave devices untouched (:528-531)
  * 'global' action mode reads the current from action[1] (the duration
    slot) and always uses a 1 ns pulse - the reference's indexing
    (:413-418: current=action[1], duration=action[2] if present else 1e-9)
  * energy at pre-update resistance, E = J^2 A^2 R dt per affected device
  * thermal fluctuations are accepted in the config but never applied
    (the reference's inline dynamics have no thermal term)

``coupling_update='simultaneous'`` (opt-in, accelerator-first) replaces the
reference's sequential-in-place semantics with the physically sensible
simultaneous update: every substep assembles ALL devices' coupling fields
from the same pre-substep pattern in one (N,N)x(B,N,3) einsum and advances
every affected device together (and refreshes the field each of the 10
Euler substeps instead of freezing the slope). Unlike the sequential quirk
it is invariant to device labeling (permutation-equivariant - tested) and
runs with no lax.scan over N, so it scales to array sizes the reference's
O(N^2)-per-device Python loop cannot touch. Default stays 'sequential' for
reference parity.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..constants import GAMMA
from ..devices import make_device_params
from ..devices.resistance import pulse_energy as _pulse_energy
from ..devices.resistance import resistance as _resistance
from ..rewards import CompositeReward, RewardContext

_HARDCODED_ALPHA = 0.01  # array_env.py:516
_HARDCODED_GAMMA = GAMMA  # array_env.py:517 (2.21e5)


class ArrayEnvConfig(NamedTuple):
    """Static configuration (ctor args mirror array_env.py:31-51)."""

    rows: int = 4
    cols: int = 4
    device_type: str = "stt_mram"
    max_steps: int = 200
    max_current: float = 2e6
    max_duration: float = 5e-9
    temperature: float = 300.0
    include_coupling: bool = True
    coupling_strength: float = 0.1
    coupling_type: str = "dipolar"  # 'dipolar' | 'exchange' | 'stray_field'
    action_mode: str = "individual"  # 'individual' | 'row' | 'column' | 'global'
    observation_mode: str = "array"  # 'array' | 'vector' | 'dict'
    coupling_update: str = "sequential"  # 'sequential' (parity) | 'simultaneous'
    success_threshold: float = 0.9
    energy_penalty_weight: float = 0.1
    autoreset: bool = True
    dtype: str = "float32"

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols


@struct.dataclass
class ArrayEnvState:
    pattern: Any  # (B, N, 3) flattened row-major device magnetizations
    target: Any  # (B, N, 3)
    step: Any  # (B,) int32
    total_energy: Any  # (B,)
    episode_return: Any  # (B,)
    key: Any
    reward_stats: Dict[str, Any] = struct.field(default_factory=dict)


class ArrayTimeStep(NamedTuple):
    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: Dict[str, Any]


def coupling_matrix(cfg: ArrayEnvConfig) -> np.ndarray:
    """(N, N) inter-device coupling (array_env.py:289-318)."""
    N = cfg.n_devices
    C = np.zeros((N, N))
    if not cfg.include_coupling:
        return C
    for i in range(N):
        for j in range(N):
            if i == j:
                continue
            ir, ic = divmod(i, cfg.cols)
            jr, jc = divmod(j, cfg.cols)
            d = np.sqrt((ir - jr) ** 2 + (ic - jc) ** 2)
            if cfg.coupling_type == "dipolar" and d > 0:
                C[i, j] = cfg.coupling_strength / d**3
            elif cfg.coupling_type == "exchange" and d == 1:
                C[i, j] = cfg.coupling_strength
            elif cfg.coupling_type == "stray_field" and d > 0:
                C[i, j] = cfg.coupling_strength / d**2
    return C


def checkerboard_pattern(rows: int, cols: int) -> np.ndarray:
    """Default +-z checkerboard target (array_env.py:172-180)."""
    pattern = np.zeros((rows, cols, 3))
    for i in range(rows):
        for j in range(cols):
            pattern[i, j, 2] = 1.0 if (i + j) % 2 == 0 else -1.0
    return pattern


def _default_reward_config(cfg: ArrayEnvConfig) -> Dict[str, Dict]:
    """Default composite components (array_env.py:182-221)."""

    def pattern_match(ctx: RewardContext):
        similarity = ctx.extras["pattern_similarity"]
        return jnp.where(ctx.is_success, 10.0, similarity * 5.0)

    def energy(ctx: RewardContext):
        return -ctx.step_energy / 1e-12

    def progress(ctx: RewardContext):
        return ctx.extras["pattern_improvement"]

    def uniformity(ctx: RewardContext):
        return jnp.maximum(0.0, 1.0 - ctx.extras["magnitude_std"])

    return {
        "pattern_match": {"weight": 10.0, "function": pattern_match},
        "energy": {"weight": -cfg.energy_penalty_weight, "function": energy},
        "progress": {"weight": 1.0, "function": progress},
        "uniformity": {"weight": 2.0, "function": uniformity},
    }


class SpinTorqueArrayEnv:
    """Vectorized crossbar array environment (functional API)."""

    def __init__(
        self,
        array_size: Tuple[int, int] = (4, 4),
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_pattern: Optional[np.ndarray] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[ArrayEnvConfig] = None,
        **config_overrides,
    ):
        if config is None:
            config = ArrayEnvConfig(
                rows=array_size[0], cols=array_size[1], device_type=device_type,
                **config_overrides,
            )
        self.config = config
        self.batch_size = batch_size
        dtype = config.jnp_dtype

        self.device_params = make_device_params(
            config.device_type, device_params, dtype=dtype
        )
        self.coupling = jnp.asarray(coupling_matrix(config), dtype)

        if target_pattern is None:
            target = checkerboard_pattern(config.rows, config.cols)
        else:
            target = np.asarray(target_pattern, float)
            if target.shape != (config.rows, config.cols, 3):
                raise ValueError(
                    f"Target pattern shape must be {(config.rows, config.cols, 3)}"
                )
        self.target_pattern = jnp.asarray(
            target.reshape(config.n_devices, 3), dtype
        )

        if config.coupling_update not in ("sequential", "simultaneous"):
            raise ValueError(
                "coupling_update must be 'sequential' or 'simultaneous', got "
                f"{config.coupling_update!r}"
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

    def step(self, state: ArrayEnvState, action):
        return self._step(state, action)

    def observe(self, state: ArrayEnvState):
        return self._observe_jit(state)

    # ------------------------------------------------------------- internals

    def _reset_impl(self, key: jax.Array) -> ArrayEnvState:
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, N = self.batch_size, cfg.n_devices
        key, k_m = jax.random.split(key)
        m = jax.random.normal(k_m, (B, N, 3), dtype)
        m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
        stats = self.reward.init_stats(B, dtype) if self.reward.needs_stats else {}
        return ArrayEnvState(
            pattern=m,
            target=jnp.broadcast_to(self.target_pattern, (B, N, 3)),
            step=jnp.zeros((B,), jnp.int32),
            total_energy=jnp.zeros((B,), dtype),
            episode_return=jnp.zeros((B,), dtype),
            key=key,
            reward_stats=stats,
        )

    def _decode_action(self, action):
        """(affected_mask (B, N), current (B,), duration (B,)) from the
        reference's action layouts (array_env.py:413-443)."""
        cfg = self.config
        dtype = cfg.jnp_dtype
        action = jnp.asarray(action, dtype)
        if action.ndim == 1:
            action = action[None, :]
        B, N = action.shape[0], cfg.n_devices
        rows_idx = jnp.arange(N, dtype=jnp.int32) // cfg.cols
        cols_idx = jnp.arange(N, dtype=jnp.int32) % cfg.cols

        if cfg.action_mode == "global":
            # Reference indexing quirk: current comes from action[1]; with a
            # 2-element global action there is no action[2], so duration is
            # always the 1 ns default (array_env.py:413-418).
            current = action[:, 1]
            duration = jnp.full((B,), 1e-9, dtype)
            mask = jnp.ones((B, N), bool)
        else:
            sel = action[:, 0]
            current = action[:, 1]
            duration = action[:, 2] if action.shape[1] > 2 else jnp.full((B,), 1e-9, dtype)
            if cfg.action_mode == "individual":
                idx = jnp.clip(sel.astype(jnp.int32), 0, N - 1)
                mask = jnp.arange(N)[None, :] == idx[:, None]
            elif cfg.action_mode == "row":
                idx = jnp.clip(sel.astype(jnp.int32), 0, cfg.rows - 1)
                mask = rows_idx[None, :] == idx[:, None]
            elif cfg.action_mode == "column":
                idx = jnp.clip(sel.astype(jnp.int32), 0, cfg.cols - 1)
                mask = cols_idx[None, :] == idx[:, None]
            else:
                raise ValueError(f"Unknown action mode: {cfg.action_mode}")
        current = jnp.clip(current, -cfg.max_current, cfg.max_current)
        duration = jnp.clip(duration, 1e-12, cfg.max_duration)
        return mask, current, duration

    def _device_field(self, pattern, d):
        """Effective field for device d: intrinsic anisotropy + coupling
        (array_env.py:478-495; STT intrinsic field is anisotropy-only,
        stt_mram.py:56-76)."""
        p = self.device_params
        from ..constants import MU0

        m_d = pattern[:, d, :]  # (B, 3)
        e = jnp.asarray(p.easy_axis)
        e = e / jnp.linalg.norm(e)
        k_u = p.uniaxial_anisotropy
        ms = p.saturation_magnetization
        hi = jax.lax.Precision.HIGHEST  # float32 physics, never TF32
        cos_t = jnp.matmul(pattern[:, d, :], e, precision=hi)
        h = (2.0 * k_u / (MU0 * ms)) * cos_t[:, None] * e[None, :]
        # coupling: sum_j C[d, j] * m_j over the CURRENT (partially updated)
        # pattern - one contraction replaces the reference's Python loop.
        h = h + jnp.einsum("n,bnc->bc", self.coupling[d], pattern, precision=hi)
        return h

    def _device_update(self, m, h_eff, current, duration):
        """Constant-slope 10-substep Euler (array_env.py:497-531)."""
        dtype = m.dtype
        p_hat = jnp.asarray([0.0, 0.0, 1.0], dtype)
        tau = 0.1 * current[:, None] * jnp.cross(m, jnp.cross(m, jnp.broadcast_to(p_hat, m.shape)))
        dmdt = -_HARDCODED_GAMMA * jnp.cross(m, h_eff)
        dmdt = dmdt + _HARDCODED_ALPHA * jnp.cross(m, dmdt)
        dmdt = dmdt + tau
        dt = (duration / 10.0)[:, None]
        out = m
        for _ in range(10):
            out = out + dmdt * dt
            out = out / jnp.linalg.norm(out, axis=-1, keepdims=True)
        # Zero-current devices stay exactly put (array_env.py:528-531).
        return jnp.where((jnp.abs(current) > 1e-12)[:, None], out, m)

    def _simultaneous_sweep(self, pattern, mask, current, duration):
        """All affected devices advance together (coupling_update=
        'simultaneous'): each of the 10 Euler substeps assembles EVERY
        device's field from the same pre-substep pattern in one
        (N,N)x(B,N,3) einsum and refreshes the slope, instead of the
        reference's sequential-in-place constant-slope loop
        (array_env.py:446-531). Same per-device dynamics law (hardcoded
        alpha/gamma, tau = 0.1 J m x (m x z), zero-current freeze) so the
        two modes differ ONLY in coupling semantics; permutation-
        equivariant and lax.scan-free, so it scales to large N."""
        cfg = self.config
        dtype = cfg.jnp_dtype
        p = self.device_params
        from ..constants import MU0

        e = jnp.asarray(p.easy_axis, dtype)
        e = e / jnp.linalg.norm(e)
        h_k = 2.0 * p.uniaxial_anisotropy / (MU0 * p.saturation_magnetization)
        p_hat = jnp.asarray([0.0, 0.0, 1.0], dtype)
        j = current[:, None, None]
        dt = (duration / 10.0)[:, None, None]
        act = (mask & (jnp.abs(current)[:, None] > 1e-12))[:, :, None]

        def substep(_, m):
            # HIGHEST: float32 physics contractions must not run in TF32.
            cos_t = jnp.einsum("bnc,c->bn", m, e, precision=jax.lax.Precision.HIGHEST)
            h = h_k * cos_t[..., None] * e
            h = h + jnp.einsum("nm,bmc->bnc", self.coupling, m,
                               precision=jax.lax.Precision.HIGHEST)
            prec = -_HARDCODED_GAMMA * jnp.cross(m, h)
            dmdt = prec + _HARDCODED_ALPHA * jnp.cross(m, prec)
            dmdt = dmdt + 0.1 * j * jnp.cross(
                m, jnp.cross(m, jnp.broadcast_to(p_hat, m.shape)))
            out = m + dmdt * dt
            out = out / jnp.linalg.norm(out, axis=-1, keepdims=True)
            return jnp.where(act, out, m)

        new_pattern = jax.lax.fori_loop(0, 10, substep, pattern)
        # Energy law identical to the sequential mode: pre-update
        # resistance per affected device (each device's own pre-step m).
        r = _resistance(cfg.device_type, pattern[..., 0], pattern[..., 1],
                        pattern[..., 2], self.device_params)
        e_dev = _pulse_energy(current[:, None], duration[:, None], r,
                              self.device_params.area)
        step_energy = jnp.sum(jnp.where(mask, e_dev, 0.0), axis=-1)
        return new_pattern, step_energy

    def _similarity(self, pattern, target):
        return jnp.mean(jnp.sum(pattern * target, axis=-1), axis=-1)

    def _observe(self, state: ArrayEnvState):
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, N = state.pattern.shape[0], cfg.n_devices
        if cfg.observation_mode == "array":
            cur = state.pattern.reshape(B, cfg.rows, cfg.cols, 3)
            tgt = state.target.reshape(B, cfg.rows, cfg.cols, 3)
            return jnp.concatenate([cur, tgt], axis=-1)
        similarity = self._similarity(state.pattern, state.target)
        if cfg.observation_mode == "vector":
            return jnp.concatenate(
                [
                    state.pattern.reshape(B, -1),
                    state.target.reshape(B, -1),
                    similarity[:, None],
                    ((cfg.max_steps - state.step) / cfg.max_steps).astype(dtype)[:, None],
                    (state.total_energy / 1e-12)[:, None],
                    jnp.full((B, 1), cfg.temperature / 300.0, dtype),
                ],
                axis=-1,
            )
        return {
            "current_pattern": state.pattern.reshape(B, cfg.rows, cfg.cols, 3),
            "target_pattern": state.target.reshape(B, cfg.rows, cfg.cols, 3),
            "pattern_similarity": similarity[:, None],
            "steps_remaining": (cfg.max_steps - state.step)[:, None],
            "total_energy": state.total_energy[:, None],
        }

    def _step_impl(self, state: ArrayEnvState, action, mesh=None):
        # ``mesh`` accepted for step-API uniformity with SpinTorqueEnv
        # (measurement/rollout harnesses pass it); this env's dynamics
        # are plain XLA elementwise ops that auto-partition without it.
        del mesh
        cfg = self.config
        dtype = cfg.jnp_dtype
        B, N = self.batch_size, cfg.n_devices

        key, k_m = jax.random.split(state.key)
        mask, current, duration = self._decode_action(action)

        prev_similarity = self._similarity(state.pattern, state.target)

        if cfg.coupling_update == "simultaneous":
            pattern, step_energy = self._simultaneous_sweep(
                state.pattern, mask, current, duration)
        else:
            # Sequential masked update over devices: device d sees updates
            # of devices < d through the coupling field, matching the
            # reference's in-place loop ordering.
            def dev_step(carry, d):
                pattern, energy = carry
                m_d = pattern[:, d, :]
                h = self._device_field(pattern, d)
                m_new = self._device_update(m_d, h, current, duration)
                active = mask[:, d]
                m_out = jnp.where(active[:, None], m_new, m_d)
                pattern = pattern.at[:, d, :].set(m_out)
                r = _resistance(cfg.device_type, m_d[:, 0], m_d[:, 1],
                                m_d[:, 2], self.device_params)
                e = _pulse_energy(current, duration, r,
                                  self.device_params.area)
                energy = energy + jnp.where(active, e, 0.0)
                return (pattern, energy), None

            (pattern, step_energy), _ = jax.lax.scan(
                dev_step,
                (state.pattern, jnp.zeros((B,), dtype)),
                jnp.arange(N, dtype=jnp.int32),
            )

        total_energy = state.total_energy + step_energy
        step = state.step + 1

        similarity = self._similarity(pattern, state.target)
        improvement = similarity - prev_similarity
        is_success = similarity >= cfg.success_threshold
        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        magnitudes = jnp.linalg.norm(pattern, axis=-1)  # (B, N)
        mid_state = state.replace(
            pattern=pattern, step=step, total_energy=total_energy, key=key
        )
        obs_step = self._observe(mid_state)

        ctx = RewardContext(
            is_success=is_success,
            step_energy=step_energy,
            alignment=similarity,
            alignment_improvement=improvement,
            magnetization_norm=magnitudes.mean(-1),
            step_count=step,
            total_energy=total_energy,
            action_current=current,
            action_duration=duration,
            extras={
                "pattern_similarity": similarity,
                "pattern_improvement": improvement,
                "magnitude_std": magnitudes.std(-1),
            },
        )
        reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
        episode_return = state.episode_return + reward

        info = {
            "step_count": step,
            "total_energy": total_energy,
            "pattern_similarity": similarity,
            "pattern_improvement": improvement,
            "is_success": is_success,
            "step_energy": step_energy,
            "episode_return": episode_return,
            "reward_components": breakdown,
        }

        if cfg.autoreset:
            m_reset = jax.random.normal(k_m, (B, N, 3), dtype)
            m_reset = m_reset / jnp.linalg.norm(m_reset, axis=-1, keepdims=True)
            d1, d3 = done[:, None], done[:, None, None]
            zero = jnp.zeros((B,), dtype)
            next_state = mid_state.replace(
                pattern=jnp.where(d3, m_reset, pattern),
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

        return next_state, ArrayTimeStep(
            obs=obs, reward=reward, terminated=terminated, truncated=truncated,
            info=info,
        )
