"""Gymnasium adapters over the functional vectorized environments.

The functional API (envs/spin_torque.py) is the fast path: jitted, batched,
device-resident. These adapters provide the reference's Gymnasium surface
(spin_torque_env.py:26-745) for compatibility with stable-baselines3 and
other host-loop RL libraries:

  * GymSpinTorqueEnv   - single-env gymnasium.Env (B=1 under the hood)
  * VectorSpinTorqueEnv - gymnasium.vector.VectorEnv-style batched adapter

Host<->device transfer happens once per step (obs out, action in); for
maximum throughput use the functional API or parallel/rollout.py instead.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError as e:  # pragma: no cover
    raise ImportError("gymnasium is required for the Gym adapters") from e

from .spin_torque import SpinTorqueEnv, SpinTorqueEnvConfig


def _warn_ignored_kwargs(cls_name: str, extra: dict) -> None:
    """The adapters tolerate unknown ctor kwargs (gym.make merges
    registration defaults with user kwargs, and reference-style call sites
    pass device fields loosely) — but tolerance must not mean SILENCE: a
    misspelled or unrouted knob (e.g. the coupling_update slip this guard
    came from) would otherwise quietly run default physics."""
    if extra:
        import warnings

        warnings.warn(
            f"{cls_name}: ignoring unknown constructor kwargs "
            f"{sorted(extra)} (unrecognized by this environment)",
            stacklevel=3,
        )


def _make_spaces(env: SpinTorqueEnv):
    """Spaces declared in the ENV's float dtype: under jax x64 the env
    computes float64 observations, and a space that claims float32 then
    fails gymnasium's official env_checker (and sb3's space checks) on
    dtype - caught by tests/integration/test_gym_api_compliance.py."""
    cfg = env.config
    f_dtype = np.dtype(cfg.dtype)
    if cfg.action_mode == "continuous":
        action_space = spaces.Box(
            low=np.array([-cfg.max_current, 0.0], dtype=f_dtype),
            high=np.array([cfg.max_current, cfg.max_duration], dtype=f_dtype),
            dtype=f_dtype,
        )
    else:
        action_space = spaces.Discrete(env.num_actions)

    if cfg.observation_mode == "vector":
        observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=(12,), dtype=f_dtype
        )
    else:
        # Unit-vector bounds widened by a float epsilon: renormalized
        # components can land a few ulps outside [-1, 1].
        unit = 1.0 + 1e-5
        observation_space = spaces.Dict(
            {
                "magnetization": spaces.Box(-unit, unit, shape=(3,), dtype=f_dtype),
                "target": spaces.Box(-unit, unit, shape=(3,), dtype=f_dtype),
                "resistance": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "temperature": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "steps_remaining": spaces.Box(
                    0, cfg.max_steps, shape=(1,), dtype=np.int32
                ),
                "energy_consumed": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "last_action": spaces.Box(-np.inf, np.inf, shape=(2,), dtype=f_dtype),
            }
        )
    return action_space, observation_space


def _to_numpy_obs(obs, squeeze: bool, space=None):
    """Device arrays -> numpy in the DECLARED space dtype (jax may compute
    in a wider dtype than the space advertises, e.g. weak-typed promotions
    under x64)."""
    if isinstance(obs, dict):
        out = {}
        for k, v in obs.items():
            arr = np.asarray(v)
            if space is not None and k in space.spaces:
                arr = arr.astype(space.spaces[k].dtype, copy=False)
            out[k] = arr
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out
    arr = np.asarray(obs)
    if space is not None:
        arr = arr.astype(space.dtype, copy=False)
    return arr[0] if squeeze else arr


def _scalar_info(info: Dict[str, Any], idx: Optional[int] = None) -> Dict[str, Any]:
    out = {}
    for k, v in info.items():
        if k in ("reward_components",):
            continue
        arr = np.asarray(v)
        if idx is not None and arr.ndim >= 1:
            arr = arr[idx]
        out[k] = arr.item() if arr.ndim == 0 and arr.size == 1 else arr
    return out


class GymSpinTorqueEnv(gym.Env):
    """Single-environment Gymnasium adapter (reference API surface)."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(
        self,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        max_steps: int = 100,
        max_current: float = 2e6,
        max_duration: float = 5e-9,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "continuous",
        observation_mode: str = "vector",
        success_threshold: float = 0.9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        batch_size: int = 1,
        dtype: str | None = None,
        # Integrator knobs beyond the reference surface — routed
        # explicitly so they cannot be silently swallowed by ``extra``
        # (review finding). None = "not supplied": only user-provided
        # values are forwarded, so SpinTorqueEnvConfig stays the single
        # source of truth for defaults (it documents each knob).
        method: str | None = None,
        max_substeps: int | None = None,
        noise_mode: str | None = None,
        rk4_noise: str | None = None,
        use_pallas: bool | None = None,
        **extra,
    ):
        # This adapter is the reference-faithful compatibility surface; the
        # reference's freeze-on-blowup semantics (PulseResult.failed) depend
        # on float64 overflow thresholds, so it uses float64 whenever x64 is
        # enabled (the parity/test configuration), and float32 otherwise;
        # the functional/vector API defaults to float32 everywhere for speed.
        _warn_ignored_kwargs("GymSpinTorqueEnv", extra)
        if dtype is None:
            dtype = "float64" if jax.config.jax_enable_x64 else "float32"
        super().__init__()
        self._ctor = dict(
            device_type=device_type,
            device_params=device_params,
            target_states=target_states,
            reward_components=reward_components,
        )
        self._cfg_kwargs = dict(
            max_steps=max_steps,
            max_current=max_current,
            max_duration=max_duration,
            temperature=temperature,
            include_thermal=include_thermal_fluctuations,
            action_mode=action_mode,
            observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False,
            dtype=dtype,
        )
        # use_pallas=None is itself the config's meaningful "auto" default,
        # so forwarding only non-None values is behavior-preserving there.
        self._cfg_kwargs.update({
            k: v for k, v in dict(
                method=method, max_substeps=max_substeps,
                noise_mode=noise_mode, rk4_noise=rk4_noise,
                use_pallas=use_pallas,
            ).items() if v is not None
        })
        self._build_env()
        self.render_mode = render_mode
        self.action_space, self.observation_space = _make_spaces(self._env)
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._state = None
        self.episode_history: List[Dict[str, Any]] = []

    def _build_env(self):
        cfg = SpinTorqueEnvConfig(device_type=self._ctor["device_type"], **self._cfg_kwargs)
        self._env = SpinTorqueEnv(
            device_type=self._ctor["device_type"],
            device_params=self._ctor["device_params"],
            target_states=self._ctor["target_states"],
            batch_size=1,
            reward_components=self._ctor["reward_components"],
            config=cfg,
        )

    @property
    def device_type(self) -> str:
        return self._env.config.device_type

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        # Seed gymnasium's np_random too (the official env_checker and some
        # wrappers require super().reset(seed=...) semantics); the actual
        # sampling runs on the jax PRNG below.
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        options = options or {}
        if "temperature" in options:
            self._cfg_kwargs["temperature"] = float(options["temperature"])
            self._build_env()
        self._key, sub = jax.random.split(self._key)
        state, obs = self._env.reset(sub)
        # Optional deterministic overrides (spin_torque_env.py:286-299).
        if "initial_state" in options:
            m = np.asarray(options["initial_state"], float)
            m = m / np.linalg.norm(m)
            state = state.replace(
                m=jnp.asarray(m, self._env.config.jnp_dtype)[None, :]
            )
        if "target_state" in options:
            t = np.asarray(options["target_state"], float)
            t = t / np.linalg.norm(t)
            state = state.replace(
                target=jnp.asarray(t, self._env.config.jnp_dtype)[None, :]
            )
        self._state = state
        self.episode_history = []
        obs = self._env.observe(state)
        info = {
            "step_count": 0,
            "total_energy": 0.0,
            "current_alignment": float(
                np.sum(np.asarray(state.m)[0] * np.asarray(state.target)[0])
            ),
        }
        return _to_numpy_obs(obs, squeeze=True, space=self.observation_space), info

    def step(self, action):
        if self._state is None:
            raise RuntimeError("Environment must be reset before calling step")
        if np.isscalar(action) or (
            isinstance(action, np.ndarray) and action.ndim == 0
        ):
            batched = np.asarray([action])
        else:
            batched = np.asarray(action)[None, ...]
        self._state, ts = self._env.step(self._state, batched)
        obs = _to_numpy_obs(ts.obs, squeeze=True, space=self.observation_space)
        reward = float(np.asarray(ts.reward)[0])
        terminated = bool(np.asarray(ts.terminated)[0])
        truncated = bool(np.asarray(ts.truncated)[0])
        info = _scalar_info(ts.info, idx=0)
        self.episode_history.append(
            {
                "step": info.get("step_count"),
                "action": np.asarray(batched)[0],
                "magnetization": np.asarray(self._state.m)[0].copy(),
                "reward": reward,
                "energy": info.get("step_energy"),
                "alignment": info.get("current_alignment"),
            }
        )
        return obs, reward, terminated, truncated, info

    def analyze_episode(self) -> Dict[str, Any]:
        """Episode summary (spin_torque_env.py:720-745)."""
        if not self.episode_history:
            return {}
        total_energy = sum(h["energy"] for h in self.episode_history)
        final_alignment = self.episode_history[-1]["alignment"]
        success = final_alignment >= self._env.config.success_threshold
        switching_step = next(
            (
                i + 1
                for i, h in enumerate(self.episode_history)
                if h["alignment"] >= self._env.config.success_threshold
            ),
            None,
        )
        return {
            "episode_length": len(self.episode_history),
            "total_energy": total_energy,
            "final_alignment": final_alignment,
            "success": success,
            "switching_step": switching_step,
            "average_reward": float(
                np.mean([h["reward"] for h in self.episode_history])
            ),
            "energy_efficiency": final_alignment / total_energy if total_energy > 0 else 0,
            "history": list(self.episode_history),
        }

    def get_device_info(self) -> Dict[str, Any]:
        from ..devices import device_factory

        return device_factory.create_device(
            self._env.config.device_type, self._ctor["device_params"]
        ).get_device_info()

    # ---- monitoring surfaces (spin_torque_env.py:699-718) ----

    def get_health_report(self) -> Dict[str, Any]:
        from ..utils.monitoring import default_health_monitor

        report = default_health_monitor().run()
        report["episode_steps"] = len(self.episode_history)
        return report

    def get_solver_info(self) -> Dict[str, Any]:
        cfg = self._env.config
        return {
            "method": cfg.method,
            "max_substeps": cfg.resolved_max_substeps(),
            "use_pallas": bool(cfg.use_pallas),
            "thermal": cfg.include_thermal,
            "noise_mode": cfg.noise_mode,
            "rk4_noise": cfg.rk4_noise,
            "dtype": cfg.dtype,
        }

    def get_performance_stats(self) -> Dict[str, Any]:
        import jax

        return {
            "solver": self.get_solver_info(),
            "health": self.get_health_report(),
            "backend": jax.default_backend(),
            "devices": jax.device_count(),
        }

    def render(self):  # pragma: no cover - optional visualization
        if self.render_mode is None:
            return None
        from ..utils.rendering import render_spin_torque

        return render_spin_torque(self, mode=self.render_mode)

    def close(self):
        pass


class VectorSpinTorqueEnv(gym.Env):
    """Batched adapter: numpy in/out over the functional env (B > 1).

    Follows the gymnax auto-reset convention: when an env is done, the
    returned observation is the *reset* observation and
    info['final_observation'] holds the terminal one.
    """

    def __init__(
        self,
        num_envs: int = 4096,
        seed: Optional[int] = None,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        reward_components: Optional[Dict[str, Dict]] = None,
        include_thermal_fluctuations: bool = True,
        **cfg_kwargs,
    ):
        self.num_envs = num_envs
        cfg = SpinTorqueEnvConfig(
            device_type=device_type,
            include_thermal=include_thermal_fluctuations,
            autoreset=True,
            **cfg_kwargs,
        )
        self._env = SpinTorqueEnv(
            device_type=device_type,
            device_params=device_params,
            target_states=target_states,
            batch_size=num_envs,
            reward_components=reward_components,
            config=cfg,
        )
        self.single_action_space, self.single_observation_space = _make_spaces(self._env)
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._state = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        # Seed gymnasium's np_random too (the official env_checker and some
        # wrappers require super().reset(seed=...) semantics); the actual
        # sampling runs on the jax PRNG below.
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, sub = jax.random.split(self._key)
        self._state, obs = self._env.reset(sub)
        return _to_numpy_obs(obs, squeeze=False, space=self.single_observation_space), {}

    def step(self, actions):
        self._state, ts = self._env.step(self._state, jnp.asarray(actions))
        return (
            _to_numpy_obs(ts.obs, squeeze=False, space=self.single_observation_space),
            np.asarray(ts.reward),
            np.asarray(ts.terminated),
            np.asarray(ts.truncated),
            _scalar_info(ts.info),
        )

    @property
    def functional_env(self) -> SpinTorqueEnv:
        return self._env

    def close(self):
        pass


class GymSpinTorqueArrayEnv(gym.Env):
    """Single-environment Gymnasium adapter for the crossbar array env
    (reference surface: array_env.py:20-755)."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        array_size=(4, 4),
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_pattern=None,
        max_steps: int = 200,
        max_current: float = 2e6,
        max_duration: float = 5e-9,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        include_coupling: bool = True,
        coupling_strength: float = 0.1,
        coupling_type: str = "dipolar",
        coupling_update: str = "sequential",
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "individual",
        observation_mode: str = "array",
        success_threshold: float = 0.9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        dtype: str | None = None,
        **extra,
    ):
        from .array import ArrayEnvConfig, SpinTorqueArrayEnv

        _warn_ignored_kwargs("GymSpinTorqueArrayEnv", extra)
        super().__init__()
        if dtype is None:
            dtype = "float64" if jax.config.jax_enable_x64 else "float32"
        del include_thermal_fluctuations  # accepted, unused (as in reference)
        cfg = ArrayEnvConfig(
            rows=array_size[0], cols=array_size[1], device_type=device_type,
            max_steps=max_steps, max_current=max_current,
            max_duration=max_duration, temperature=temperature,
            include_coupling=include_coupling,
            coupling_strength=coupling_strength, coupling_type=coupling_type,
            coupling_update=coupling_update,
            action_mode=action_mode, observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False, dtype=dtype,
        )
        self._env = SpinTorqueArrayEnv(
            device_params=device_params, target_pattern=target_pattern,
            batch_size=1, reward_components=reward_components, config=cfg,
        )
        self.render_mode = render_mode
        self._setup_spaces()
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._state = None
        self.n_rows, self.n_cols = cfg.rows, cfg.cols
        self.n_devices = cfg.n_devices

    def _setup_spaces(self):
        # Spaces in the env's float dtype, like _make_spaces: under x64 the
        # env computes float64 and a float32 space would either fail the
        # official env_checker or force a lossy downcast at the boundary.
        cfg = self._env.config
        f_dtype = np.dtype(cfg.dtype)
        N, R, C = cfg.n_devices, cfg.rows, cfg.cols
        if cfg.action_mode == "individual":
            hi0 = N - 1
        elif cfg.action_mode == "row":
            hi0 = R - 1
        elif cfg.action_mode == "column":
            hi0 = C - 1
        else:
            hi0 = None
        if hi0 is None:  # global
            self.action_space = spaces.Box(
                low=np.array([-cfg.max_current, 0.0], f_dtype),
                high=np.array([cfg.max_current, cfg.max_duration], f_dtype),
                dtype=f_dtype,
            )
        else:
            self.action_space = spaces.Box(
                low=np.array([0, -cfg.max_current, 0.0], f_dtype),
                high=np.array([hi0, cfg.max_current, cfg.max_duration], f_dtype),
                dtype=f_dtype,
            )
        unit = 1.0 + 1e-5  # renormalized components can sit a few ulps out
        if cfg.observation_mode == "array":
            self.observation_space = spaces.Box(
                low=-unit, high=unit, shape=(R, C, 6), dtype=f_dtype
            )
        elif cfg.observation_mode == "vector":
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(N * 6 + 4,), dtype=f_dtype
            )
        else:
            self.observation_space = spaces.Dict(
                {
                    "current_pattern": spaces.Box(-unit, unit, shape=(R, C, 3), dtype=f_dtype),
                    "target_pattern": spaces.Box(-unit, unit, shape=(R, C, 3), dtype=f_dtype),
                    # Mean alignment (dot product) with the target pattern:
                    # genuinely ranges over [-1, 1], not [0, 1] - the
                    # official env_checker caught the old [0, 1] claim.
                    "pattern_similarity": spaces.Box(-unit, unit, shape=(1,), dtype=f_dtype),
                    "steps_remaining": spaces.Box(0, cfg.max_steps, shape=(1,), dtype=np.int32),
                    "total_energy": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                }
            )

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        # Seed gymnasium's np_random too (the official env_checker and some
        # wrappers require super().reset(seed=...) semantics); the actual
        # sampling runs on the jax PRNG below.
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        options = options or {}
        self._key, sub = jax.random.split(self._key)
        state, obs = self._env.reset(sub)
        cfg = self._env.config
        if "initial_pattern" in options:
            p = np.asarray(options["initial_pattern"], float).reshape(
                cfg.n_devices, 3
            )
            state = state.replace(
                pattern=jnp.asarray(p, cfg.jnp_dtype)[None]
            )
        if "target_pattern" in options:
            t = np.asarray(options["target_pattern"], float).reshape(
                cfg.n_devices, 3
            )
            state = state.replace(target=jnp.asarray(t, cfg.jnp_dtype)[None])
        self._state = state
        obs = self._env.observe(state)
        return _to_numpy_obs(obs, squeeze=True, space=self.observation_space), {"step_count": 0}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("Environment must be reset before calling step")
        self._state, ts = self._env.step(self._state, np.asarray(action)[None, ...])
        return (
            _to_numpy_obs(ts.obs, squeeze=True, space=self.observation_space),
            float(np.asarray(ts.reward)[0]),
            bool(np.asarray(ts.terminated)[0]),
            bool(np.asarray(ts.truncated)[0]),
            _scalar_info(ts.info, idx=0),
        )

    def set_target_pattern(self, pattern):
        cfg = self._env.config
        t = np.asarray(pattern, float).reshape(cfg.n_devices, 3)
        if self._state is not None:
            self._state = self._state.replace(
                target=jnp.asarray(t, cfg.jnp_dtype)[None]
            )

    def close(self):
        pass


class GymSkyrmionRacetrackEnv(gym.Env):
    """Single-environment Gymnasium adapter for the skyrmion racetrack env
    (reference surface: skyrmion_env.py:20-870)."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 20}

    def __init__(
        self,
        track_length: float = 1000e-9,
        track_width: float = 200e-9,
        track_thickness: float = 2e-9,
        n_skyrmions: int = 1,
        skyrmion_radius: float = 20e-9,
        target_positions=None,
        max_steps: int = 150,
        max_current: float = 1e12,
        max_gradient: float = 1e18,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        include_pinning: bool = True,
        pinning_strength: float = 0.1,
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "continuous",
        observation_mode: str = "vector",
        success_threshold: float = 10e-9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        dtype: str | None = None,
        **extra,
    ):
        from .skyrmion import SkyrmionEnvConfig, SkyrmionRacetrackEnv

        _warn_ignored_kwargs("GymSkyrmionRacetrackEnv", extra)
        super().__init__()
        if dtype is None:
            dtype = "float64" if jax.config.jax_enable_x64 else "float32"
        cfg = SkyrmionEnvConfig(
            track_length=track_length, track_width=track_width,
            track_thickness=track_thickness, n_skyrmions=n_skyrmions,
            skyrmion_radius=skyrmion_radius, max_steps=max_steps,
            max_current=max_current, max_gradient=max_gradient,
            temperature=temperature,
            include_thermal=include_thermal_fluctuations,
            include_pinning=include_pinning, pinning_strength=pinning_strength,
            action_mode=action_mode, observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False, dtype=dtype,
        )
        self._env = SkyrmionRacetrackEnv(
            target_positions=target_positions, batch_size=1,
            reward_components=reward_components, config=cfg,
            seed=0 if seed is None else seed,
        )
        self.render_mode = render_mode
        self._setup_spaces()
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._state = None
        self.n_skyrmions = n_skyrmions
        self.track_length = track_length

    def _setup_spaces(self):
        # Spaces in the env's float dtype (see _make_spaces rationale).
        cfg = self._env.config
        f_dtype = np.dtype(cfg.dtype)
        n = cfg.n_skyrmions
        if cfg.action_mode == "continuous":
            self.action_space = spaces.Box(
                low=np.array(
                    [-cfg.max_current, -cfg.max_current,
                     -cfg.max_gradient, -cfg.max_gradient, 0.0], f_dtype
                ),
                high=np.array(
                    [cfg.max_current, cfg.max_current,
                     cfg.max_gradient, cfg.max_gradient, 2e-9], f_dtype
                ),
                dtype=f_dtype,
            )
        else:
            self.action_space = spaces.Discrete(self._env.num_actions)
        if cfg.observation_mode == "vector":
            obs_size = n * 4 + n * 2 + 4
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(obs_size,), dtype=f_dtype
            )
        else:
            self.observation_space = spaces.Dict(
                {
                    "positions": spaces.Box(0, cfg.track_length, shape=(n, 2), dtype=f_dtype),
                    "velocities": spaces.Box(-np.inf, np.inf, shape=(n, 2), dtype=f_dtype),
                    "target_positions": spaces.Box(0, cfg.track_length, shape=(n,), dtype=f_dtype),
                    "position_errors": spaces.Box(0, np.inf, shape=(n,), dtype=f_dtype),
                    "steps_remaining": spaces.Box(0, cfg.max_steps, shape=(1,), dtype=np.int32),
                    "total_energy": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                }
            )

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        # Seed gymnasium's np_random too (the official env_checker and some
        # wrappers require super().reset(seed=...) semantics); the actual
        # sampling runs on the jax PRNG below.
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        options = options or {}
        self._key, sub = jax.random.split(self._key)
        state, obs = self._env.reset(sub)
        cfg = self._env.config
        if "initial_positions" in options:
            p = np.asarray(options["initial_positions"], float)
            state = state.replace(
                positions=jnp.asarray(p, cfg.jnp_dtype)[None]
            )
        if "target_positions" in options:
            self._env.set_targets(options["target_positions"])
        self._state = state
        obs = self._env.observe(state)
        return _to_numpy_obs(obs, squeeze=True, space=self.observation_space), {"step_count": 0}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("Environment must be reset before calling step")
        if np.isscalar(action) or (
            isinstance(action, np.ndarray) and action.ndim == 0
        ):
            batched = np.asarray([action])
        else:
            batched = np.asarray(action)[None, ...]
        self._state, ts = self._env.step(self._state, batched)
        return (
            _to_numpy_obs(ts.obs, squeeze=True, space=self.observation_space),
            float(np.asarray(ts.reward)[0]),
            bool(np.asarray(ts.terminated)[0]),
            bool(np.asarray(ts.truncated)[0]),
            _scalar_info(ts.info, idx=0),
        )

    def close(self):
        pass
