"""Chip smoke test: SpinTorque-v0 and the PPO trainer on one NVIDIA GPU.

    python3 chip_smoke.py          # one card: phases 1-6
    python3 chip_smoke.py --four   # four cards: the sharded path only

Phases (one card), each printing one line or more:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. compiling the env step with the GPU pulse kernel at B=4096 and
     B=65536, deterministic and thermal, with its memory analysis;
  3. the kernel against the XLA float32 path and an XLA float64 reference
     (euler, heun, rk4, tilted axis): pass if the kernel's worst angular
     error against float64 is at most 2x XLA float32's, and the `failed`
     flags are identical (at resolved and at the env's full currents);
  4. thermal statistics with the kernel engaged: moments of the kernel's
     own normals, then the Boltzmann and Neel-Brown gates of
     tests/unit/test_thermal_physical_validation.py at their full sizes;
  5. env-step throughput, kernel and XLA, at both sizes, thermal and
     deterministic: median and spread over fresh compiles;
  6. a few PPO train steps at B=4096, hidden (256, 256), rollout 16,
     4 minibatches, with finite losses.

``--four`` runs only the four-card path and what it is compared with: the
env step sharded over 4 cards against 1 card (bitwise equal, deterministic
and thermal), and one PPO train step on ('data', 'model') meshes of (4, 1)
and (2, 2) against 1 card.

The last line of standard output is one JSON object, printed only when
every phase passed:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU the script exits nonzero before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# Pass rules, stated beside each result.
DET_ERR_RATIO = 2.0  # kernel max angle vs f64 <= this x XLA f32's
NOISE_MOMENT_SIGMAS = 5.0  # |mean|, |std-1| within this many standard errors
PPO_PARAM_ATOL = 1e-3  # mesh vs one card, after one train step (3x Adam lr)
PPO_METRIC_RTOL = 1e-3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _angles_deg(a, b):
    """Angle between unit-vector batches, accurate for tiny angles."""
    a = np.stack([np.asarray(c, np.float64) for c in a], -1)
    b = np.stack([np.asarray(c, np.float64) for c in b], -1)
    cross = np.linalg.norm(np.cross(a, b), axis=-1)
    return np.degrees(np.arctan2(cross, (a * b).sum(-1)))


def _pulse_inputs(B, seed, max_duration=5e-9, max_current=2e6):
    """Random unit m0 and pulses over the env's action range."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    spans = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32,
                               1e-12, max_duration)
    cur = jax.random.uniform(jax.random.fold_in(key, 2), (B,), jnp.float32,
                             -max_current, max_current)
    return (m[:, 0], m[:, 1], m[:, 2]), spans, cur


# --------------------------------------------------------------------- phases

def phase_compile(sizes=(4096, 65536), max_substeps=0):
    """Compile the env step (kernel engaged) per size and thermal mode."""
    import jax

    from spintorque_tpu.envs import SpinTorqueEnv

    lines = []
    for B in sizes:
        for thermal in (False, True):
            env = SpinTorqueEnv(batch_size=B, include_thermal=thermal,
                                max_substeps=max_substeps)
            assert env.config.use_pallas, "kernel not selected"
            state, _ = env.reset(jax.random.PRNGKey(0))
            action = jax.numpy.zeros((B, 2), env.config.jnp_dtype)
            t0 = time.perf_counter()
            compiled = jax.jit(env._step_impl).lower(state, action).compile()
            dt = time.perf_counter() - t0
            ma = compiled.memory_analysis()
            mem = {k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes",
            ) if hasattr(ma, k)}
            lines.append(f"env step B={B} thermal={thermal}: compiled in {dt:.2f} s, "
                         f"memory_analysis {mem}")
    return lines


def phase_deterministic(B=4096, max_substeps=5001, max_duration=5e-9):
    """Kernel vs XLA float32 vs XLA float64 on the card.

    Angles are compared on pulses with currents within +-1e-7 A/m^2: the
    reference's STT coefficient P J / (Ms V) is ~1e17 per A/m^2 for the
    default device, so larger currents overflow RK4 at the dt law's step and
    take the freeze path (``failed``), which carries no trajectory to
    compare. The failed flags are compared at the env's full current range,
    where most pulses freeze."""
    import jax
    import jax.numpy as jnp

    from spintorque_tpu.devices import make_device_params
    from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas
    from spintorque_tpu.physics import IntegratorConfig, integrate_pulse

    base = make_device_params("stt_mram", None, dtype=jnp.float32).llgs()
    cases = [
        ("euler", base), ("heun", base), ("rk4", base),
        ("rk4 tilted", base.replace(easy_axis=jnp.asarray([0.6, 0.0, 0.8], jnp.float32))),
    ]
    resolved = _pulse_inputs(B, 1, max_duration=max_duration, max_current=1e-7)
    env_range = _pulse_inputs(B, 2, max_duration=max_duration)
    lines, bad = [], []
    for name, params in cases:
        cfg = IntegratorConfig(method=name.split()[0], max_substeps=max_substeps)
        m0, spans, cur = resolved
        kern = integrate_pulse_pallas(m0, spans, cur, params, cfg)
        x32 = integrate_pulse(m0, spans, cur, params, cfg)
        with jax.enable_x64(True):
            x64 = integrate_pulse(
                tuple(jnp.asarray(c, jnp.float64) for c in m0),
                jnp.asarray(spans, jnp.float64), jnp.asarray(cur, jnp.float64),
                params.astype(jnp.float64), cfg,
            )
            x64_m = [np.asarray(c) for c in x64.m]
            f64_failed = np.asarray(x64.failed)
        k_failed, x_failed = np.asarray(kern[3]), np.asarray(x32.failed)
        live = ~(k_failed | x_failed | f64_failed)
        a_k = _angles_deg(kern[0], x64_m)[live]
        a_x = _angles_deg(x32.m, x64_m)[live]
        e_k = float(a_k.max()) if a_k.size else 0.0
        e_x = float(a_x.max()) if a_x.size else 0.0
        same = bool(np.array_equal(k_failed, x_failed))
        m0, spans, cur = env_range
        kf = np.asarray(integrate_pulse_pallas(m0, spans, cur, params, cfg)[3])
        xf = np.asarray(integrate_pulse(m0, spans, cur, params, cfg).failed)
        same_env = bool(np.array_equal(kf, xf))
        ok = live.sum() > B // 2 and e_k <= DET_ERR_RATIO * e_x and same and same_env
        lines.append(
            f"{name}: angle vs f64 over {int(live.sum())}/{B} envs (|J| <= 1e-7): kernel max "
            f"{e_k:.3e} p99 {np.percentile(a_k, 99):.3e} deg, XLA f32 max {e_x:.3e} p99 "
            f"{np.percentile(a_x, 99):.3e} deg (rule: kernel max <= {DET_ERR_RATIO:g}x XLA f32 "
            f"max); failed flags identical {same}, and at |J| <= 2e6 {same_env} "
            f"({int(kf.sum())}/{B} frozen) -> {'pass' if ok else 'FAIL'}"
        )
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"deterministic comparison failed: {bad}\n" + "\n".join(lines))
    return lines


def phase_thermal(noise_batch=65536, full_gates=True):
    """Moments of the kernel's normals, then the physics gates."""
    import importlib.util
    from pathlib import Path

    import jax
    from scipy import stats

    from spintorque_tpu.ops.pallas_integrator import sample_kernel_normals
    from spintorque_tpu.physics import IntegratorConfig

    lines = []
    for rk4_noise in ("per_substep", "per_stage"):
        cfg = IntegratorConfig(method="rk4", thermal=True, rk4_noise=rk4_noise)
        z = np.asarray(sample_kernel_normals(cfg, jax.random.PRNGKey(5), noise_batch,
                                             substeps=4), np.float64)
        s = z.ravel()
        n = s.size
        mean_se, std_se = 1 / np.sqrt(n), 1 / np.sqrt(2 * n)
        rows = z.reshape(-1, z.shape[-1])
        corr = np.corrcoef(rows)[~np.eye(len(rows), dtype=bool)]
        ks = stats.kstest(s, "norm").pvalue
        ok = (abs(s.mean()) < NOISE_MOMENT_SIGMAS * mean_se
              and abs(s.std() - 1) < NOISE_MOMENT_SIGMAS * std_se
              and np.abs(corr).max() < NOISE_MOMENT_SIGMAS / np.sqrt(z.shape[-1])
              and ks > 1e-4 and np.isfinite(s).all())
        lines.append(
            f"kernel normals {rk4_noise} (n={n}): mean {s.mean():+.2e}, std {s.std():.5f}, "
            f"skew {stats.skew(s):+.3f}, kurtosis {stats.kurtosis(s):+.3f}, KS p {ks:.3f}, "
            f"max |corr| {np.abs(corr).max():.4f} (rule: mean, std-1 within "
            f"{NOISE_MOMENT_SIGMAS:g} s.e., KS p > 1e-4) -> {'pass' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError("\n".join(lines))
    if full_gates:
        path = Path(__file__).resolve().parent / "tests/unit/test_thermal_physical_validation.py"
        spec = importlib.util.spec_from_file_location("thermal_gates", path)
        gates = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gates)
        t0 = time.perf_counter()
        ks_p, m2, m2_th = gates.boltzmann_gate(**gates.BOLTZMANN_FULL, use_pallas=True)
        lines.append(
            f"Boltzmann gate (kernel, {gates.BOLTZMANN_FULL}): KS p {ks_p:.3f} "
            f"(> {gates.BOLTZMANN_FULL['ks_min']}), <mz^2> {m2:.4f} vs {m2_th:.4f} "
            f"(tol {gates.BOLTZMANN_FULL['m2_tol']}) -> pass "
            f"[{time.perf_counter() - t0:.1f} s]")
        for g in gates.NEEL_BROWN_FULL:
            t0 = time.perf_counter()
            ratio = gates.neel_brown_gate(**g, use_pallas=True)
            lines.append(
                f"Neel-Brown gate (kernel, sigma={g['sigma']}, B={g['B']}): rate / lambda_1 "
                f"{ratio:.3f} in ({g['lo']}, {g['hi']}) -> pass "
                f"[{time.perf_counter() - t0:.1f} s]")
    return lines


def phase_timing(card, sizes=(4096, 65536), compiles=3, max_substeps=0,
                 warmup=3, blocks=3):
    """Env-step throughput, kernel vs XLA, over fresh compiles."""
    import jax

    from spintorque_tpu.envs import SpinTorqueEnv
    from spintorque_tpu.utils.benchmark import measure_env_throughput

    lines = []
    cache_was_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # fresh compiles
    try:
        for B in sizes:
            for thermal in (False, True):
                for use_kernel in (True, False):
                    medians = []
                    for _ in range(compiles):
                        jax.clear_caches()
                        env = SpinTorqueEnv(batch_size=B, include_thermal=thermal,
                                            use_pallas=use_kernel,
                                            max_substeps=max_substeps)
                        # XLA dispatches take ~1-2 s each at these sizes: one
                        # dispatch per block keeps the phase short.
                        rates, _ = measure_env_throughput(
                            env, warmup=warmup if use_kernel else 1, blocks=blocks,
                            iters_per_block=8 if use_kernel else 1)
                        medians.append(float(np.median(rates)))
                    med = float(np.median(medians))
                    lines.append(
                        f"env step B={B} thermal={thermal} "
                        f"{'kernel' if use_kernel else 'XLA   '}: median {med:.1f} "
                        f"env-steps/s over {compiles} fresh compiles "
                        f"(per-compile medians {[round(m, 1) for m in medians]}, "
                        f"spread {max(medians) - min(medians):.1f}) [{card}]")
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_was_on)
    return lines


def phase_ppo(card, B=4096, hidden=(256, 256), rollout=16, minibatches=4, steps=3,
              max_substeps=0):
    """A few PPO train steps through the trainer the CLI runs."""
    import jax

    from spintorque_tpu.envs import SpinTorqueEnv
    from spintorque_tpu.rl import PPOConfig, PPOTrainer

    env = SpinTorqueEnv(batch_size=B, max_substeps=max_substeps)
    trainer = PPOTrainer(env, PPOConfig(hidden_sizes=hidden, rollout_steps=rollout,
                                        num_minibatches=minibatches))
    ts = trainer.init(jax.random.PRNGKey(0))
    lines = []
    t0 = time.perf_counter()
    ts, metrics = trainer.train_step(ts)
    jax.block_until_ready(ts.params)
    lines.append(f"first train_step (compile + run) {time.perf_counter() - t0:.2f} s")
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        ts, metrics = trainer.train_step(ts)
        jax.block_until_ready(ts.params)
        times.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite PPO metrics: {vals}")
        lines.append(f"train_step {i}: loss {vals['loss']:.4g}, pg {vals['pg_loss']:.4g}, "
                     f"v {vals['v_loss']:.4g}, reward {vals['mean_reward']:.4g}")
    med = float(np.median(times))
    lines.append(f"PPO B={B} kernel={env.config.use_pallas}: median train_step {med * 1e3:.1f} ms, "
                 f"{B * rollout / med:.1f} train env-steps/s [{card}]")
    return lines


def phase_four(n_cards=4, sizes=(4096, 65536), steps=3, max_substeps=0,
               ppo_hidden=(256, 256), ppo_rollout=16):
    """Sharded env step and PPO train step against one card."""
    import jax
    from jax.sharding import Mesh

    from spintorque_tpu.envs import SpinTorqueEnv
    from spintorque_tpu.parallel import make_mesh, random_policy, shard_env_state
    from spintorque_tpu.rl import PPOConfig, PPOTrainer

    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards:
        raise AssertionError(f"needs {n_cards} devices, found {len(jax.devices())}")
    one = Mesh(np.asarray(devs[:1]).reshape(1, 1), ("data", "model"))
    lines = []

    def run_env(B, thermal, mesh):
        env = SpinTorqueEnv(batch_size=B, include_thermal=thermal,
                            max_substeps=max_substeps, mesh=mesh)
        policy = random_policy(env)
        state, obs = env.reset(jax.random.PRNGKey(3))
        state = shard_env_state(state, mesh)
        key = jax.random.PRNGKey(4)
        for i in range(steps):
            action = policy(None, obs, jax.random.fold_in(key, i))
            state, ts = env.step(state, action)
            obs = ts.obs
        return env.config.use_pallas, jax.device_get(state), jax.device_get(obs)

    for B, thermal in [(b, t) for b in sizes for t in (False, True)]:
        k1, s1, o1 = run_env(B, thermal, one)
        mesh = make_mesh(n_data=n_cards, n_model=1, devices=devs)
        k4, s4, o4 = run_env(B, thermal, mesh)
        leaves1, leaves4 = jax.tree.leaves((s1, o1)), jax.tree.leaves((s4, o4))
        equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(leaves1, leaves4))
        lines.append(f"env {steps} steps B={B} thermal={thermal} kernel={k1 and k4}: "
                     f"{n_cards} cards vs 1 card bitwise equal: {equal} (rule: bitwise)")
        if not equal:
            diff = max(float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
                       for a, b in zip(leaves1, leaves4))
            raise AssertionError("\n".join(lines) + f"\nmax |diff| {diff:.3e}")

    B = sizes[0]

    def ppo_step(mesh):
        env = SpinTorqueEnv(batch_size=B, max_substeps=max_substeps)
        trainer = PPOTrainer(env, PPOConfig(hidden_sizes=ppo_hidden,
                                            rollout_steps=ppo_rollout), mesh=mesh)
        ts = trainer.init(jax.random.PRNGKey(0))
        ts, metrics = trainer.train_step(ts)
        return jax.device_get(ts.params), {k: float(v) for k, v in metrics.items()}

    p1, m1 = ppo_step(one)
    for shape in ((n_cards, 1), (2, n_cards // 2)):
        mesh = make_mesh(n_data=shape[0], n_model=shape[1], devices=devs)
        p, m = ppo_step(mesh)
        dp = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                 for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p)))
        dm = max(abs(m[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in m1)
        ok = dp <= PPO_PARAM_ATOL and dm <= PPO_METRIC_RTOL
        lines.append(
            f"PPO train_step mesh {shape} vs 1 card: max |dparam| {dp:.3e} "
            f"(<= {PPO_PARAM_ATOL:g}), max rel dmetric {dm:.3e} (<= {PPO_METRIC_RTOL:g}) "
            f"-> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("\n".join(lines))
    return lines


# ----------------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded path and its comparison")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); refusing to run",
              file=sys.stderr)
        return 2

    from spintorque_tpu.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    count = len(jax.devices())
    print(f"PHASE 1 device: {jax.devices()} kind {dev.device_kind!r} count {count} "
          f"SMs {getattr(dev, 'core_count', 'not reported')}; compile cache {cache}",
          flush=True)
    print(f"card: {card}", flush=True)

    if args.four:
        phases = [("four-card sharded path", lambda: phase_four())]
        want = 4
    else:
        phases = [
            ("compile", phase_compile),
            ("deterministic comparison", phase_deterministic),
            ("thermal statistics", phase_thermal),
            ("env-step timing", lambda: phase_timing(card)),
            ("PPO train steps", lambda: phase_ppo(card)),
        ]
        want = 1
    failed = []
    for i, (name, fn) in enumerate(phases, start=2):
        t0 = time.perf_counter()
        try:
            for line in fn():
                print(f"  {line}", flush=True)
            print(f"PHASE {i} {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"PHASE {i} {name}: FAILED ({time.perf_counter() - t0:.1f} s)", flush=True)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if count < want:
        print(f"chip_smoke: expected {want} devices, found {count}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
