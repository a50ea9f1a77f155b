"""Steady-state throughput measurement for the vectorized envs.

THE one measurement program: bench.py (the headline), chip_smoke.py's
timing phase, the ladder recorder (scripts/record_tpu_bench.py), and the CLI
`benchmark` subcommand
all call measure_env_throughput, so no recorded number can come from a
lookalike of the measured program.
"""

import time

import jax


def measure_env_throughput(
    env,
    *,
    # n_inner: env steps per dispatched scan program. 16 matches the
    # production PPO trainer's rollout length (PPOConfig.rollout_steps) -
    # the headline measures the program shape production actually runs.
    n_inner: int = 16,
    warmup: int = 12,
    blocks: int = 1,
    iters_per_block: int = 8,
    seed: int = 0,
    make_action=None,
    return_final=False,
    mesh=None,
):
    """Steady-state throughput of the public vectorized env step program.

    Builds the jitted scan-of-steps program (the headline program), shards
    the env batch over a ('data','model') mesh covering all local devices,
    warms to steady state (``warmup`` dispatches), then times ``blocks``
    independent blocks of ``iters_per_block`` dispatches with ONE device
    sync per block (a per-dispatch sync would add a host round trip to
    every iteration).

    ``make_action(key, batch_size)`` overrides the action source for envs
    whose action space differs from SpinTorqueEnv's (array/skyrmion) - the
    SAME measurement program serves every env, so the recorded artifact
    can never drift from the headline (scripts/record_tpu_bench.py).

    ``mesh`` overrides the default all-devices mesh (e.g. a single-device
    mesh, to compare per-card scaling through this same program).

    Returns (rates, total_env_steps_per_block) - rates is a list of
    ``blocks`` env-steps/s numbers (total across all mesh devices) - plus
    the final sharded obs when ``return_final`` (so callers/tests can
    assert the measured program kept the batch sharded).
    """
    from spintorque_tpu.parallel import (
        make_mesh,
        random_policy,
        shard_batch,
        shard_env_state,
    )

    if make_action is None:
        policy = random_policy(env)

        def make_action(key, batch_size, _obs=None):
            return policy(None, _obs, key)

        obs_driven = True
    else:
        obs_driven = False

    key = jax.random.PRNGKey(seed)
    state, obs = env.reset(key)
    if mesh is None:
        mesh = make_mesh()
    state = shard_env_state(state, mesh)
    obs = jax.tree.map(lambda x: shard_batch(x, mesh), obs)

    @jax.jit
    def step_n(state, obs, key):
        def body(carry, k):
            state, obs = carry
            if obs_driven:
                action = make_action(k, env.batch_size, _obs=obs)
            else:
                action = make_action(k, env.batch_size)
            # mesh: the GPU kernel runs per shard on multi-device meshes.
            state, ts = env._step_impl(state, action, mesh=mesh)
            return (state, ts.obs), ts.reward.mean()

        keys = jax.random.split(key, n_inner)
        # unroll=2 stays until a card measurement decides it.
        (state, obs), rewards = jax.lax.scan(body, (state, obs), keys, unroll=2)
        return state, obs, rewards.mean()

    # Pre-split all per-dispatch keys OUTSIDE the timed region and fetch
    # them to host: an eager jax.random.split per iteration is its own
    # dispatch and would be timed with the program.
    import numpy as _np

    n_keys = warmup + blocks * iters_per_block
    subs = _np.asarray(jax.random.split(key, n_keys))
    ki = 0
    r = None
    for _ in range(warmup):
        state, obs, r = step_n(state, obs, subs[ki]); ki += 1
    jax.block_until_ready(obs)

    steps_per_block = iters_per_block * n_inner * env.batch_size
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(iters_per_block):
            state, obs, r = step_n(state, obs, subs[ki]); ki += 1
        jax.block_until_ready(obs)
        rates.append(steps_per_block / (time.perf_counter() - t0))
    if return_final:
        return rates, steps_per_block, obs
    return rates, steps_per_block
