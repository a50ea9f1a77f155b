"""Record the env ladder on the local GPU into a JSON file.

The env entries are measured by bench.measure_env_throughput - literally the
SAME program as the headline bench.py, so the recorded ladder and the
headline number can never disagree about what was measured. Covers: thermal
and deterministic SpinTorque-v0, B=65536 scaling, SpinTorqueArray-v0 and
SkyrmionRacetrack-v0 throughput, and the solver micro-benches, with t-based
confidence intervals on the mean. Every run records the card's name and
power limit. Refuses to run without a GPU.

Run: python scripts/record_tpu_bench.py --output ladder.json   (one process per card)
"""

import json
import math
import os
import platform
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import card_name, measure_env_throughput

# Two-sided 95% Student-t critical values by degrees of freedom.
_T95 = {1: 12.71, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 15: 2.131, 20: 2.086}


def _tcrit(df):
    """95% two-sided t critical value; for df between table keys use the
    nearest key BELOW (t grows as df shrinks, so rounding df down is
    conservative - rounding up would report an anti-conservatively narrow
    CI). df above the table uses the largest key, also conservative."""
    if df in _T95:
        return _T95[df]
    below = [k for k in _T95 if k <= df]
    return _T95[max(below)] if below else _T95[min(_T95)]


def _jaxlib_version():
    try:
        import jaxlib

        return getattr(jaxlib, "__version__", None) or jaxlib.version.__version__
    except Exception:
        return "unknown"


def _stats(rates, name, unit, wall_s):
    """Mean with a t-based 95% CI on the MEAN (not sample percentiles)."""
    n = len(rates)
    mean = statistics.fmean(rates)
    std = statistics.stdev(rates) if n > 1 else 0.0
    half = _tcrit(n - 1) * std / math.sqrt(n) if n > 1 else 0.0
    return {
        "name": name,
        "value": mean,
        "median": statistics.median(rates),
        "unit": unit,
        "std": std,
        "ci95_mean": [mean - half, mean + half],
        "n_blocks": n,
        # Per-entry provenance: under --only, entries kept from the prior
        # artifact retain THEIR recording's backend/version/date rather than
        # being silently re-labeled by the new partial run's top-level
        # metadata (round-3 advisor finding).
        "extra": {
            "wall_s": round(wall_s, 3),
            "recorded": {
                "date": time.strftime("%Y-%m-%d"),
                "backend": jax.default_backend(),
                "jax": jax.__version__,
                "jaxlib": _jaxlib_version(),
                "card": card_name(),
            },
        },
    }


def main(path, only=None):
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {jax.devices()[0].platform!r})")
    from spintorque_tpu.compile_cache import enable_compile_cache
    from spintorque_tpu.envs import (
        SkyrmionRacetrackEnv,
        SpinTorqueArrayEnv,
        SpinTorqueEnv,
        SpinTorqueEnvConfig,
    )
    from spintorque_tpu.physics import IntegratorConfig, integrate_pulse
    from spintorque_tpu.physics.solver import params_from_dict

    enable_compile_cache()
    B = 4096
    use_pallas = True  # the GPU kernel; the env entries resolve it per config
    # --only re-records a subset: seed results with the existing artifact
    # so a partial run merges instead of clobbering the other entries.
    results = {}
    if only and os.path.exists(path):
        with open(path) as fh:
            results = json.load(fh).get("results", {})

    def want(label):
        return only is None or only in label

    def flush_json():
        out = {
            "suite": "spintorque_tpu",
            "notes": (
                "env_* entries: bench.measure_env_throughput, the exact "
                "headline program (scan of 16 public env steps per dispatch "
                "- the production PPO rollout length - one device sync per "
                "8 dispatches). solver_* entries: one host dispatch per "
                "pulse call - honest user-API latencies, not kernel "
                "throughput."
            ),
            "backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "card": card_name(),
            "devices": jax.local_device_count(),
            "platform": platform.platform(),
            "use_pallas": bool(use_pallas),
            # Top-level metadata describes the LATEST (possibly partial) run;
            # each entry's extra.recorded carries its own provenance.
            "results": results,
        }
        with open(path, "w") as fh:
            json.dump(out, fh, indent=2)

    # ---- SpinTorque-v0 entries: THE headline program (bench.py) ----------
    # n_compiles > 1: measure across executables (jax.clear_caches + fresh
    # env) and record per-compile medians; the top-line number is the median
    # over compiles, matching bench.py's discipline.
    env_cases = [
        ("env_4096_thermal", 4096, True, 3),
        ("env_4096_det", 4096, False, 3),
        ("env_65536_thermal", 65536, True, 1),
    ]
    for label, batch, thermal, n_compiles in env_cases:
        if not want(label):
            continue
        ecfg = SpinTorqueEnvConfig(dtype="float32", include_thermal=thermal)
        t_wall = time.time()
        all_rates = []
        per_compile = []
        for _ in range(n_compiles):
            if n_compiles > 1:
                jax.clear_caches()
            env = SpinTorqueEnv(batch_size=batch, config=ecfg)
            # iters_per_block=8 matches bench.py's sync cadence exactly.
            rates, _ = measure_env_throughput(
                env, blocks=8 if n_compiles == 1 else 4,
                iters_per_block=8, warmup=12)
            all_rates += rates
            per_compile.append(statistics.median(rates))
        entry = _stats(
            all_rates, f"env_steps_per_s_B{batch}_thermal={thermal}",
            "env-steps/s", time.time() - t_wall)
        if n_compiles > 1:
            entry["per_compile_medians"] = [round(m, 1) for m in per_compile]
            entry["median_of_compile_medians"] = round(
                statistics.median(per_compile), 1)
            spread = (max(per_compile) - min(per_compile)) / statistics.median(
                per_compile)
            entry["compile_spread_pct"] = round(100.0 * spread, 2)
        results[label] = entry
        print(label + ":", round(entry["value"]), flush=True)
        flush_json()

    # ---- SpinTorqueArray-v0 ladder: batch scaling x action modes ---------
    # (round-3 verdict #8: non-flagship envs get the same evidentiary
    # standard as the flagship.) 'column' is structurally identical to
    # 'row' (same masked decode with cols_idx) and is omitted.
    array_cases = [
        ("array_512_4x4", 512, "individual", {}),
        ("array_4096_4x4", 4096, "individual", {}),
        ("array_65536_4x4", 65536, "individual", {}),
        ("array_4096_4x4_row", 4096, "row", {}),
        ("array_4096_4x4_global", 4096, "global", {}),
        # Round-5: the opt-in physically-correct simultaneous-coupling mode
        # (one (N,N)x(B,N,3) einsum per substep, no lax.scan over devices)
        # vs the parity-sequential default, including a 16x16 array (N=256)
        # well past the reference's per-device Python loop regime.
        ("array_4096_4x4_simult", 4096, "individual",
         {"coupling_update": "simultaneous"}),
        ("array_4096_16x16_seq", 4096, "individual",
         {"array_size": (16, 16)}),
        ("array_4096_16x16_simult", 4096, "individual",
         {"array_size": (16, 16), "coupling_update": "simultaneous"}),
    ]
    for label, batch, mode, extra in array_cases:
        if not want(label):
            continue
        arr_env = SpinTorqueArrayEnv(batch_size=batch, dtype="float32",
                                     action_mode=mode, **extra)
        # Selector range follows the action mode's decode clip (review
        # finding: drawing 0..N-1 in 'row' mode piled 13/16 of actions onto
        # the last row). 'global' ignores the selector slot entirely.
        sel_hi = {
            "individual": arr_env.config.n_devices,
            "row": arr_env.config.rows,
            "column": arr_env.config.cols,
            "global": 1,
        }[mode]

        def arr_action(key, batch_, sel_hi=sel_hi):
            ki, kc, kd = jax.random.split(key, 3)
            idx = jax.random.randint(ki, (batch_,), 0, sel_hi).astype(jnp.float32)
            cur = jax.random.uniform(kc, (batch_,), jnp.float32, -2e6, 2e6)
            dur = jax.random.uniform(kd, (batch_,), jnp.float32, 1e-12, 5e-9)
            return jnp.stack([idx, cur, dur], axis=-1)

        t_wall = time.time()
        rates, _ = measure_env_throughput(
            arr_env, blocks=8, iters_per_block=16, warmup=12,
            make_action=arr_action)
        results[label] = _stats(
            rates, f"array_env_steps_per_s_B{batch}_4x4_{mode}",
            "env-steps/s", time.time() - t_wall)
        print(label + ":", round(results[label]["value"]), flush=True)
        flush_json()

    # ---- SkyrmionRacetrack-v0 ladder: batch scaling + discrete mode ------
    sky_cases = [
        ("skyrmion_512", 512, "continuous"),
        ("skyrmion_4096", 4096, "continuous"),
        ("skyrmion_65536", 65536, "continuous"),
        ("skyrmion_4096_discrete", 4096, "discrete"),
    ]
    for label, batch, mode in sky_cases:
        if not want(label):
            continue
        sky_env = SkyrmionRacetrackEnv(batch_size=batch, dtype="float32",
                                       action_mode=mode)
        mc, mg = sky_env.config.max_current, sky_env.config.max_gradient
        n_act = sky_env.num_actions

        def sky_action(key, batch_, mode=mode, mc=mc, mg=mg, n_act=n_act):
            if mode == "discrete":
                return jax.random.randint(key, (batch_,), 0, n_act)
            kj, kg, kd = jax.random.split(key, 3)
            j = jax.random.uniform(kj, (batch_, 2), jnp.float32, -0.5 * mc, 0.5 * mc)
            g = jax.random.uniform(kg, (batch_, 2), jnp.float32, -0.5 * mg, 0.5 * mg)
            d = jax.random.uniform(kd, (batch_, 1), jnp.float32, 1e-12, 2e-9)
            return jnp.concatenate([j, g, d], axis=-1)

        t_wall = time.time()
        rates, _ = measure_env_throughput(
            sky_env, blocks=8, iters_per_block=16, warmup=12,
            make_action=sky_action)
        results[label] = _stats(
            rates, f"skyrmion_env_steps_per_s_B{batch}_{mode}",
            "env-steps/s", time.time() - t_wall)
        print(label + ":", round(results[label]["value"]), flush=True)
        flush_json()

    # ---- Solver micro-benches: 1000-substep 1 ns pulses ------------------
    # Two entries: deterministic (round-1-comparable config: thermal OFF,
    # 1000 substeps) and thermal, under keys whose names say what they run
    # (the old artifact reused the round-1 key for a changed config -
    # round-2 advisor finding).
    p = params_from_dict(
        dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
             uniaxial_anisotropy=1.2e6, polarization=0.7,
             easy_axis=np.array([0.0, 0.0, 1.0]))
    )
    key = jax.random.PRNGKey(0)
    m = jax.random.normal(key, (B, 3), jnp.float32)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jnp.full((B,), 1e-9, jnp.float32)
    cur = jnp.full((B,), 1e2, jnp.float32)
    for label, thermal in (("solver_4096x1000_det", False),
                           ("solver_4096x1000_thermal", True)):
        if not want(label):
            continue
        cfg = IntegratorConfig(method="rk4", max_substeps=1024, thermal=thermal,
                               use_pallas=use_pallas)
        f = jax.jit(lambda m0, k, cfg=cfg: integrate_pulse(
            m0, spans, cur, p, cfg, key=k))
        t_wall = time.time()
        # Keys pre-split to host numpy OUTSIDE the timed loops (an eager
        # fold_in per block is its own runtime dispatch and was the source
        # of the 4x-wide solver CI in the round-2 artifact).
        solver_keys = np.asarray(jax.random.split(key, 8))
        jax.block_until_ready(f(m0, key))
        for _ in range(10):  # steady-state warmup
            jax.block_until_ready(f(m0, key))
        rates = []
        for i in range(8):
            t0 = time.perf_counter()
            for _ in range(6):
                r = f(m0, solver_keys[i])
            jax.block_until_ready(r)
            rates.append(6 * B / (time.perf_counter() - t0))
        results[label] = _stats(
            rates, f"solver_pulses_per_s_B4096_1000substeps_thermal={thermal}",
            "pulses/s", time.time() - t_wall)
        print(label + ":", round(results[label]["value"]), flush=True)
        flush_json()
    print("wrote", path, flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True, help="JSON file to write")
    ap.add_argument("--only", default=None,
                    help="re-record only entries whose key contains this "
                         "substring; other entries are kept from the "
                         "existing file")
    args = ap.parse_args()
    main(args.output, only=args.only)
