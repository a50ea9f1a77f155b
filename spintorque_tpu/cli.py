"""Command-line interface: info / train / eval / benchmark / config.

Counterpart of the reference CLI (spin_torque_gym/cli.py:43-418). The
``train`` subcommand runs the native on-device PPO trainer by default (the
reference shells out to stable-baselines3 on host CPU); ``--backend sb3``
keeps the reference's behavior through the Gymnasium adapter when
stable-baselines3 is installed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def cmd_info(args) -> int:
    import jax

    from . import __version__
    from .devices import DEVICE_TYPES
    from .envs import SpinTorqueEnvConfig

    print(f"spintorque-tpu {__version__}")
    print(f"backend: {jax.default_backend()}  devices: {jax.device_count()}")
    print("\nRegistered environments:")
    for env_id, steps in [
        ("SpinTorque-v0", 100),
        ("SpinTorqueArray-v0", 200),
        ("SkyrmionRacetrack-v0", 150),
    ]:
        print(f"  {env_id:24s} max_episode_steps={steps}")
    print("\nDevice types:", ", ".join(DEVICE_TYPES))
    cfg = SpinTorqueEnvConfig()
    print("\nSpinTorque-v0 defaults:")
    for k, v in cfg._asdict().items():
        print(f"  {k:24s} {v}")
    return 0


def cmd_train(args) -> int:
    import jax

    from .config import ConfigManager
    from .rl import PPOConfig, PPOTrainer

    manager = ConfigManager(args.config)
    c = manager.config
    if args.timesteps:
        c.training.total_timesteps = args.timesteps
    if args.batch_size:
        c.environment.batch_size = args.batch_size
    if args.env and args.env != "SpinTorque-v0":
        print(f"train currently targets SpinTorque-v0 (got {args.env})", file=sys.stderr)

    if args.backend == "sb3":
        return _train_sb3(args, c)

    if c.compute.distributed or c.compute.coordinator_address:
        from .parallel import initialize

        initialize(coordinator_address=c.compute.coordinator_address)

    env = manager.make_env()
    mesh = None
    if jax.device_count() > 1:
        from .parallel import make_mesh

        mesh = make_mesh(
            n_data=c.compute.mesh_data or None,
            n_model=max(1, c.compute.mesh_model),
        )
    trainer = PPOTrainer(
        env,
        PPOConfig(
            rollout_steps=c.training.rollout_steps,
            num_epochs=c.training.num_epochs,
            num_minibatches=c.training.num_minibatches,
            learning_rate=c.training.learning_rate,
            gamma=c.training.gamma,
            gae_lambda=c.training.gae_lambda,
            clip_eps=c.training.clip_eps,
            hidden_sizes=tuple(c.training.hidden_sizes),
        ),
        mesh=mesh,
    )

    def log(i, metrics):
        line = " ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items()))
        print(f"update {i}: {line}")

    ts, summary = trainer.train(
        c.training.total_timesteps, seed=c.training.seed,
        log_every=args.log_every, callback=log,
    )
    print(json.dumps({k: v for k, v in summary.items()}, default=float))

    if args.output:
        from .utils.checkpoint import save_params

        save_params(args.output, ts.params)
        print(f"saved policy parameters to {args.output}")
    return 0


def _train_sb3(args, c) -> int:
    try:
        import gymnasium as gym
        import stable_baselines3 as sb3
    except ImportError:
        print("stable-baselines3 not installed; use --backend native", file=sys.stderr)
        return 1
    import spintorque_tpu  # noqa: F401  (registers env ids)

    algo = {"ppo": sb3.PPO, "sac": sb3.SAC, "td3": sb3.TD3,
            "dqn": sb3.DQN}.get(args.algorithm)
    if algo is None:
        print(f"Unknown sb3 algorithm {args.algorithm}", file=sys.stderr)
        return 1
    # DQN needs a discrete action space (reference cli.py:257-277 wires DQN
    # but its discrete mode is broken; ours works - see envs/gym_adapter.py).
    kwargs = {"action_mode": "discrete"} if args.algorithm == "dqn" else {}
    env = gym.make(args.env or "SpinTorque-v0", **kwargs)
    model = algo("MlpPolicy", env, verbose=1)
    t0 = time.time()
    model.learn(total_timesteps=c.training.total_timesteps)
    elapsed = time.time() - t0
    if args.output:
        model.save(args.output)
    print(f"trained {c.training.total_timesteps} steps in {elapsed:.1f}s "
          f"({c.training.total_timesteps / elapsed:.1f} steps/s)")
    return 0


def cmd_eval(args) -> int:
    import jax
    import jax.numpy as jnp

    from .config import ConfigManager
    from .parallel import random_policy, rollout_jit, summarize

    manager = ConfigManager(args.config)
    if args.batch_size:
        manager.config.environment.batch_size = args.batch_size
    env = manager.make_env()

    if args.model:
        from .rl import PPOConfig, PPOTrainer
        from .utils.checkpoint import load_params

        trainer = PPOTrainer(env, PPOConfig())
        params = load_params(args.model)

        def policy(p, obs, key):
            env_action, _, log_prob, value = trainer._policy(p, obs, key)
            return env_action, log_prob, value

        policy_params = params
    else:
        policy = random_policy(env)
        policy_params = None

    run = rollout_jit(env, policy, args.episodes_steps)
    state, obs = env.reset(jax.random.PRNGKey(args.seed))
    t0 = time.perf_counter()
    state, obs, traj = run(policy_params, state, obs, jax.random.PRNGKey(args.seed + 1))
    jax.block_until_ready(traj.reward)
    elapsed = time.perf_counter() - t0
    stats = {k: float(np.asarray(v)) for k, v in summarize(traj).items()}
    stats["elapsed_s"] = elapsed
    stats["env_steps_per_s"] = traj.reward.size / elapsed
    print(json.dumps(stats))
    if args.output:
        Path(args.output).write_text(json.dumps(stats, indent=2))
    return 0


def _cmd_benchmark(args) -> int:
    import jax

    from .envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from .utils.benchmark import measure_env_throughput

    B = args.batch_size or 4096
    env = SpinTorqueEnv(
        batch_size=B,
        config=SpinTorqueEnvConfig(dtype="float32",
                                   include_thermal=not args.no_thermal),
    )
    # The SAME measurement program as bench.py and the recorded artifact
    # (utils/benchmark.py): mesh-sharded batch, steady-state warmup, one
    # device sync per block of dispatches, keys pre-split outside timing.
    rates, _ = measure_env_throughput(
        env,
        n_inner=args.inner,
        warmup=min(12, 2 * args.iters),
        blocks=1,
        iters_per_block=args.iters,
    )
    steps_per_s = rates[0]
    result = {
        "batch_size": B,
        "backend": jax.default_backend(),
        "devices": jax.device_count(),
        "env_steps_per_s": steps_per_s,
        "env_steps_per_s_per_chip": steps_per_s / jax.device_count(),
        "ms_per_batched_step": B / steps_per_s * 1e3,
    }
    print(json.dumps(result))
    return 0


def cmd_config(args) -> int:
    from .config import ConfigManager

    manager = ConfigManager(args.config)
    if args.action == "show":
        print(json.dumps(manager.config.to_dict(), indent=2, default=str))
    elif args.action == "validate":
        manager.validate()
        print("configuration valid")
    elif args.action == "save":
        if not args.output:
            print("--output required for save", file=sys.stderr)
            return 1
        manager.save(args.output)
        print(f"saved to {args.output}")
    return 0


def cmd_serve(args) -> int:
    from .deployment import ServingEndpoint

    ep = ServingEndpoint(
        host=args.host,
        port=args.port,
        refresh_interval=args.refresh_interval,
        run_device_checks=not args.no_device_checks,
    )
    print(f"serving health endpoint on {args.host}:{ep.port} "
          f"(/healthz /readiness /metrics /info)")
    try:
        ep.serve_forever()
    except KeyboardInterrupt:
        ep.stop()
    return 0


def cmd_sweep(args) -> int:
    """Switching-probability phase diagram over a (current, duration) grid
    (research/sweeps.py) - one sharded batch through the pulse integrator."""
    import json as _json

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .devices import make_device_params
    from .parallel import make_mesh
    from .research.sweeps import switching_probability_diagram

    params = make_device_params(args.device_type, None, dtype=jnp.float32).llgs()
    currents = jnp.linspace(args.current_min, args.current_max, args.n_currents)
    durations = jnp.linspace(args.duration_min, args.duration_max,
                             args.n_durations)
    out = switching_probability_diagram(
        params, currents, durations, n_ensemble=args.ensemble,
        temperature=args.temperature, key=jax.random.PRNGKey(args.seed),
        mesh=make_mesh(),
    )
    def _jsonable(a):
        # NaN marks a grid point whose whole ensemble failed; bare NaN
        # tokens are invalid strict JSON, so emit null there.
        return np.where(np.isfinite(a), a.astype(object), None).tolist()

    result = {
        "device_type": args.device_type,
        "temperature": args.temperature,
        "ensemble": args.ensemble,
        "currents": np.asarray(out["currents"]).tolist(),
        "durations": np.asarray(out["durations"]).tolist(),
        "p_switch": _jsonable(np.asarray(out["p_switch"])),
        "failed_fraction": np.asarray(out["failed_fraction"]).tolist(),
    }
    text = _json.dumps(result, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spintorque-tpu",
        description="Accelerator-native spintronic RL environment engine",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("info", help="environment and backend info")
    sp.set_defaults(func=cmd_info)

    sp = sub.add_parser("train", help="train an RL agent")
    sp.add_argument("--env", default="SpinTorque-v0")
    sp.add_argument("--algorithm", default="ppo")
    sp.add_argument("--backend", choices=["native", "sb3"], default="native")
    sp.add_argument("--timesteps", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    sp.add_argument("--log-every", type=int, default=10)
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("eval", help="evaluate a policy (or random)")
    sp.add_argument("--model", default=None)
    sp.add_argument("--episodes-steps", type=int, default=200,
                    help="rollout horizon in env steps")
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(func=cmd_eval)

    sp = sub.add_parser("benchmark", help="measure env throughput")
    sp.add_argument("--batch-size", type=int, default=4096)
    sp.add_argument("--iters", type=int, default=5)
    sp.add_argument("--inner", type=int, default=16)
    sp.add_argument("--no-thermal", action="store_true")
    sp.set_defaults(func=_cmd_benchmark)

    sp = sub.add_parser(
        "sweep",
        help="switching-probability phase diagram over a (J, duration) grid",
    )
    sp.add_argument("--device-type", default="stt_mram")
    sp.add_argument("--current-min", type=float, default=-4e6)
    sp.add_argument("--current-max", type=float, default=0.0)
    sp.add_argument("--n-currents", type=int, default=16)
    sp.add_argument("--duration-min", type=float, default=1e-10)
    sp.add_argument("--duration-max", type=float, default=2e-9)
    sp.add_argument("--n-durations", type=int, default=16)
    sp.add_argument("--ensemble", type=int, default=64)
    sp.add_argument("--temperature", type=float, default=300.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", default=None, help="write JSON here")
    sp.set_defaults(func=cmd_sweep)

    sp = sub.add_parser("config", help="show/validate/save configuration")
    sp.add_argument("action", choices=["show", "validate", "save"])
    sp.add_argument("--config", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(func=cmd_config)

    sp = sub.add_parser(
        "serve", help="HTTP health/readiness/metrics endpoint"
    )
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--refresh-interval", type=float, default=60.0)
    sp.add_argument("--no-device-checks", action="store_true",
                    help="skip device-touching health probes (CI/sidecar)")
    sp.set_defaults(func=cmd_serve)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
