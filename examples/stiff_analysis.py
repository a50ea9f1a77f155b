"""Adaptive-solver analysis: explicit RK45 vs the order-5 Radau IIA path.

The reference exposes scipy's stiff methods (Radau/BDF/LSODA) through its
adaptive LLGS solver for analysis work (spin_torque_gym/physics/
llgs_solver.py:26,35); here the same names run the batched accelerator-native
3-stage Radau IIA (physics/adaptive.py). This example shows where the
implicit path earns its keep: a high-damping relaxation whose fast
precession caps the explicit solver's step size forever, while Radau's
dt grows to dt_max once the transient decays — a whole batch of initial
conditions integrating in lockstep, each with its own (t, dt).

Run: python examples/stiff_analysis.py   (CPU or GPU; ~30 s)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from spintorque_tpu.physics import LLGSParams, integrate_adaptive


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--span", type=float, default=5e-9)
    ap.add_argument("--rtol", type=float, default=1e-6)
    args = ap.parse_args()

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    params = LLGSParams(
        saturation_magnetization=800e3, damping=0.5,  # overdamped: stiff
        uniaxial_anisotropy=1.2e6, volume=1e-23, polarization=0.7,
        easy_axis=jnp.array([0.0, 0.0, 1.0], dtype),
    ).astype(dtype)

    key = jax.random.PRNGKey(0)
    m = jax.random.normal(key, (args.batch, 3), dtype)
    m = m / jnp.linalg.norm(m, axis=-1, keepdims=True)
    m0 = (m[:, 0], m[:, 1], m[:, 2])
    spans = jnp.full((args.batch,), args.span, dtype)
    cur = jnp.zeros((args.batch,), dtype)

    results = {}
    for method in ("rk45", "radau"):
        t0 = time.perf_counter()
        res = integrate_adaptive(
            m0, spans, cur, params, rtol=args.rtol, atol=args.rtol * 1e-3,
            dt_max=5e-10, method=method,
        )
        jax.block_until_ready(res.m)
        wall = time.perf_counter() - t0
        ok = bool(res.success.all())
        steps = np.asarray(res.n_steps)
        results[method] = res
        print(f"{method:6s}: accepted steps mean {steps.mean():7.1f} "
              f"(min {steps.min()}, max {steps.max()}), "
              f"rejected {np.asarray(res.n_rejected).mean():.1f}, "
              f"success={ok}, wall {wall:.2f}s (incl. compile)")

    a = np.stack([np.asarray(c) for c in results["rk45"].m], axis=-1)
    b = np.stack([np.asarray(c) for c in results["radau"].m], axis=-1)
    diff = np.abs(a - b).max()
    # Everything relaxes to the easy axis; the two steppers must agree.
    frac_up = float((b[:, 2] > 0).mean())
    print(f"\nmax |rk45 - radau| over the batch: {diff:.2e}")
    print(f"relaxed to +z: {frac_up:.0%}, to -z: {1 - frac_up:.0%} "
          f"(basin split of the random initial conditions)")
    ratio = np.asarray(results["rk45"].n_steps).mean() / max(
        1.0, np.asarray(results["radau"].n_steps).mean())
    print(f"explicit/implicit accepted-step ratio: {ratio:.1f}x "
          f"(the A-stability payoff; full ladder in "
          f"docs/STIFF_SOLVER_STEPS.json)")


if __name__ == "__main__":
    main()
