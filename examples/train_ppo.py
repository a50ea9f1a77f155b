"""Train a PPO policy natively on the accelerator and record the learning curve.

The device config uses the deterministic easy-switching regime
(polarization=1e-12, damping=0.1: the simplified-STT term is comparable to
precession, so the current SIGN selects the final pole deterministically -
see tests/unit/test_rollout_rl.py::test_ppo_actually_learns_switching).
The learned policy reads the target sign out of the observation; success
climbs from ~30% (random) to ~100% within a handful of updates.

Run: python examples/train_ppo.py [--updates N] [--batch B] [--out FILE]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json

from spintorque_tpu.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu.rl import PPOConfig, PPOTrainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="network matmul dtype (the bf16 learning gate)")
    ap.add_argument("--shared-trunk", action="store_true",
                    help="one trunk for both heads (the shared-trunk gate)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    env = SpinTorqueEnv(
        batch_size=args.batch,
        config=SpinTorqueEnvConfig(
            include_thermal=False, max_duration=1e-10, max_steps=4,
            dtype="float32",
        ),
        device_params={"polarization": 1e-12, "damping": 0.1},
    )
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=8, num_epochs=4, num_minibatches=4,
                  hidden_sizes=(64, 64), learning_rate=1e-3, ent_coef=0.01,
                  compute_dtype=args.compute_dtype,
                  shared_trunk=args.shared_trunk),
    )
    curve = []

    def log(i, m):
        curve.append({"update": i, "success_rate": round(m["success_rate"], 4),
                      "mean_reward": round(m["mean_reward"], 3)})
        print(f"update {i:3d}: reward={m['mean_reward']:8.3f} "
              f"success={m['success_rate']:.3f}")

    ts, summary = trainer.train(
        total_timesteps=args.updates * 8 * args.batch,
        log_every=2,
        callback=log,
    )
    summary = {k: round(v, 3) if isinstance(v, float) else v
               for k, v in summary.items()}
    print(summary)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"curve": curve, "summary": summary}, f, indent=1)
        print(f"learning curve -> {args.out}")


if __name__ == "__main__":
    main()
