"""PPO train-step breakdown bench: where does the update time go?

Measures, in steady state on the local accelerator:
  * full train_step (the production program)
  * the SAME program with the update trace-ablated (update_from_traj
    replaced by a pass-through that still consumes every trajectory leaf,
    so XLA cannot prune rollout work) -> the update's IN-SITU marginal
  * env-steps only (random actions, no policy net) -> the policy's
    in-situ marginal
  * isolated rollout-only and update-only executables, kept as REFERENCE
    diagnostics only: separately-jitted phases are different executables
    with different schedules and extra output materialization, so their
    sum can exceed the full step - they are not an additive decomposition.
    The in-situ ablation marginals are additive BY CONSTRUCTION:
    env_only + policy_marginal + update_marginal == train_step.

Prints one JSON object with ms per phase, derived env-steps/s and the card's
name, so the rollout/training gap is attributable. Refuses to run without a
GPU.

Run: python scripts/bench_ppo.py [--batch 4096] [--rollout 16]
                                 [--compute-dtype bfloat16]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timed(fn, *args, warmup=10, iters=8, block=lambda r: r, label=""):
    """Steady-state wall time per call (s). fn must be jitted/async."""
    t0 = time.time()
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(block(out))
    print(f"# {label}: warmup+compile {time.time()-t0:.1f}s", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(block(out))
    return (time.perf_counter() - t0) / iters, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="network matmul dtype (PPOConfig.compute_dtype)")
    ap.add_argument("--shared-trunk", action="store_true",
                    help="one trunk for both heads (PPOConfig.shared_trunk)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {jax.devices()[0].platform!r})")

    from bench import card_name
    from spintorque_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from spintorque_tpu.envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from spintorque_tpu.rl.ppo import PPOConfig, PPOTrainer

    env = SpinTorqueEnv(
        batch_size=args.batch, config=SpinTorqueEnvConfig(dtype="float32")
    )
    cfg = PPOConfig(
        rollout_steps=args.rollout,
        num_epochs=args.epochs,
        num_minibatches=args.minibatches,
        compute_dtype=args.compute_dtype,
        shared_trunk=args.shared_trunk,
    )
    trainer = PPOTrainer(env, cfg)
    ts = trainer.init(jax.random.PRNGKey(0))

    results = {
        "batch": args.batch,
        "rollout_steps": args.rollout,
        "compute_dtype": args.compute_dtype,
        "shared_trunk": args.shared_trunk,
        "use_pallas": bool(env.config.use_pallas),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "card": card_name(),
    }

    # --- full train step -------------------------------------------------
    def full(ts):
        new_ts, _ = trainer.train_step(ts)
        return new_ts

    t_full, ts2 = timed(full, ts, block=lambda r: r.params, label="train_step")
    steps_per_update = args.rollout * args.batch
    results["train_step_ms"] = round(t_full * 1e3, 3)
    results["train_env_steps_per_s"] = round(steps_per_update / t_full, 1)

    # --- update trace-ablated: the IN-SITU rollout cost -------------------
    # Same _train_step_impl structure, same rollout scan, but
    # update_from_traj is replaced AT TRACE TIME with a pass-through whose
    # outputs depend (at 1e-30 weight) on every trajectory leaf, so XLA
    # cannot dead-code-eliminate the value head or log-prob work the real
    # update consumes. t_full - t_noupdate is the update's marginal in the
    # production executable.
    orig_update = trainer.update_from_traj

    def no_update(params, opt_state, traj, last_obs, key):
        keep = sum(
            jnp.asarray(v, jnp.float32).mean() for v in jax.tree.leaves(traj)
        ) + jnp.asarray(last_obs, jnp.float32).mean()
        losses = jnp.zeros((args.epochs, args.minibatches)) + keep * 1e-30
        auxes = dict(pg_loss=losses, v_loss=losses, entropy=losses)
        return params, opt_state, losses, auxes

    try:
        trainer.update_from_traj = no_update

        # A DISTINCT plain function, not jax.jit(trainer._train_step_impl):
        # bound methods compare/hash equal by (instance, function), so that
        # spelling silently REUSES the production wrapper's cached
        # executable and the trace-time patch never takes effect (measured:
        # identical runtimes and a 0.4 s "compile").
        def ablated_impl(ts):
            return trainer._train_step_impl(ts)

        noupdate_step = jax.jit(ablated_impl)
        t_noupd, _ = timed(
            noupdate_step, ts, block=lambda r: r[0].params,
            label="train_step(update ablated)",
        )
    finally:
        trainer.update_from_traj = orig_update
    results["train_step_update_ablated_ms"] = round(t_noupd * 1e3, 3)
    results["update_in_situ_ms"] = round((t_full - t_noupd) * 1e3, 3)

    # --- rollout only -----------------------------------------------------
    @jax.jit
    def rollout_only(params, env_state, obs, key):
        def body(carry, k):
            env_state, obs = carry
            env_action, raw, logp, value = trainer._policy(params, obs, k)
            nxt, out = env._step_impl(env_state, env_action)
            transition = dict(
                obs=obs, raw_action=raw, reward=out.reward,
                done=(out.terminated | out.truncated),
                log_prob=logp, value=value,
            )
            return (nxt, out.obs), transition

        keys = jax.random.split(key, args.rollout)
        (env_state, obs), traj = jax.lax.scan(
            body, (env_state, obs), keys, unroll=2
        )
        return env_state, obs, traj

    t_roll, _ = timed(
        rollout_only, ts.params, ts.env_state, ts.obs, ts.key,
        block=lambda r: r[1], label="rollout",
    )
    results["rollout_ms"] = round(t_roll * 1e3, 3)
    results["rollout_env_steps_per_s"] = round(steps_per_update / t_roll, 1)

    # --- env steps alone (no policy net), same program shape as bench.py --
    from spintorque_tpu.parallel import random_policy

    policy = random_policy(env)

    @jax.jit
    def env_only(env_state, obs, key):
        def body(carry, k):
            env_state, obs = carry
            nxt, out = env._step_impl(env_state, policy(None, obs, k))
            return (nxt, out.obs), out.reward.mean()

        keys = jax.random.split(key, args.rollout)
        (env_state, obs), r = jax.lax.scan(body, (env_state, obs), keys, unroll=2)
        return env_state, obs, r.mean()

    t_env, _ = timed(env_only, ts.env_state, ts.obs, ts.key, block=lambda r: r[2], label="env_only")
    results["env_only_ms"] = round(t_env * 1e3, 3)
    results["env_only_steps_per_s"] = round(steps_per_update / t_env, 1)

    # --- update only: THE production post-rollout program -----------------
    # trainer.update_from_traj is the same callable _train_step_impl runs
    # (bootstrap + GAE + minibatched clipped-surrogate epochs with value
    # clipping and the entropy term), timed on a frozen trajectory.
    env_state, last_obs, traj = jax.block_until_ready(
        rollout_only(ts.params, ts.env_state, ts.obs, ts.key)
    )

    @jax.jit
    def update_only(params, opt_state, key, traj, last_obs):
        params, opt_state, losses, auxes = trainer.update_from_traj(
            params, opt_state, traj, last_obs, key
        )
        return params, opt_state, losses.mean()

    t_upd, _ = timed(
        update_only, ts.params, ts.opt_state, ts.key, traj, last_obs,
        block=lambda r: r[2], label="update_only",
    )
    results["update_only_isolated_ms"] = round(t_upd * 1e3, 3)

    # Additive in-situ decomposition (sums to train_step_ms by
    # construction; the isolated rollout/update numbers above are separate
    # executables and must NOT be summed):
    results["phases_in_situ_ms"] = {
        "env_steps": results["env_only_ms"],
        "policy_marginal": round((t_noupd - t_env) * 1e3, 3),
        "update_marginal": results["update_in_situ_ms"],
    }
    results["phases_sum_ms"] = round(
        sum(results["phases_in_situ_ms"].values()), 3)
    results["phases_sum_vs_full_pct"] = round(
        100.0 * results["phases_sum_ms"] / results["train_step_ms"], 2)
    results["train_vs_rollout_only_pct"] = round(
        100.0 * t_roll / t_full, 2)
    # 'recorded' set BEFORE printing so stdout JSON and the persisted
    # file are byte-identical objects.
    results["recorded"] = time.strftime("%Y-%m-%d")
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
