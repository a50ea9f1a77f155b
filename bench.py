"""Headline benchmark: env-steps/s/chip on vectorized SpinTorque-v0.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Configuration follows BASELINE.json's north-star metric: 4096 vectorized
SpinTorque-v0 envs (default physics: STT-MRAM, thermal fluctuations on,
RK4, max_duration 5 ns), random continuous actions spanning the full action
space, measured in steady state on the local GPU. The env batch is sharded
over all local cards (no-op on one card) so the per-chip number stays honest
on multi-card hosts. The measured program is a scan of 16 env steps per
dispatch - the production PPO rollout length.

measure_env_throughput() is the ONE measurement program: the ladder
recorder (scripts/record_tpu_bench.py) imports it, so the ladder and the
headline are the same program, not lookalikes.

Refuses to run (exit 2) without a GPU: a CPU number is not a chip number.

Baseline: the reference's measured 1.802 s/step single env on CPU
(quality_gates_report.json "Performance") = 0.555 env-steps/s.
"""

import json
import subprocess
import sys

import jax

from spintorque_tpu.utils.benchmark import measure_env_throughput  # noqa: F401

REFERENCE_STEPS_PER_S = 1.0 / 1.802  # reference quality-gate measurement


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 2

    from spintorque_tpu.compile_cache import enable_compile_cache
    from spintorque_tpu.envs import SpinTorqueEnv, SpinTorqueEnvConfig

    enable_compile_cache()
    B = 4096
    cfg = SpinTorqueEnvConfig(dtype="float32")

    # Median over 3 executables (caches cleared between them), with the
    # per-executable medians in the JSON line.
    per_compile = []
    resolved_pallas = None
    for _ in range(3):
        jax.clear_caches()
        env = SpinTorqueEnv(batch_size=B, config=cfg)  # thermal, rk4, 5 ns
        resolved_pallas = bool(env.config.use_pallas)
        rates, _ = measure_env_throughput(env, blocks=3, iters_per_block=8)
        rates.sort()
        per_compile.append(rates[len(rates) // 2])
    per_compile.sort()
    # Denominator matches the mesh measure_env_throughput builds (ALL
    # devices, jax.devices()).
    n_chips = jax.device_count()
    steps_per_s_per_chip = per_compile[1] / n_chips

    print(
        json.dumps(
            {
                "metric": "env_steps_per_s_per_chip_4096envs_SpinTorque-v0",
                "value": round(steps_per_s_per_chip, 1),
                "unit": "env-steps/s/chip",
                "vs_baseline": round(steps_per_s_per_chip / REFERENCE_STEPS_PER_S, 1),
                "use_pallas": resolved_pallas,
                "backend": jax.default_backend(),
                "device_kind": dev.device_kind,
                "device_count": n_chips,
                "card": card_name(),
                "per_compile_medians": [
                    round(r / n_chips, 1) for r in per_compile
                ],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
