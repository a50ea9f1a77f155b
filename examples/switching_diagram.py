"""Switching-probability phase diagram over a (current, duration) grid.

The whole grid x thermal ensemble runs as ONE batch through the pulse
integrator (the GPU kernel on a GPU) and shards over all local cards.
Prints an ASCII diagram and writes results/switching_diagram.json.

Run: python examples/switching_diagram.py
"""

import json
import os as _os
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from spintorque_tpu.parallel import make_mesh
from spintorque_tpu.physics import LLGSParams
from spintorque_tpu.research import switching_probability_diagram

params = LLGSParams(
    saturation_magnetization=800e3, damping=0.05, uniaxial_anisotropy=1.2e6,
    volume=1e-22, polarization=0.7,
    easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32),
)

currents = jnp.linspace(-4e6, 0.0, 16)  # threshold sits near -2e6 A/m^2
durations = jnp.linspace(1e-10, 2e-9, 16)
mesh = make_mesh()  # shards the batch over all local devices (no-op on 1)

t0 = time.time()
out = switching_probability_diagram(
    params, currents, durations, n_ensemble=64, temperature=300.0,
    key=jax.random.PRNGKey(0), mesh=mesh,
)
p = np.asarray(out["p_switch"])
wall = time.time() - t0
n_traj = currents.shape[0] * durations.shape[0] * 64
print(f"{n_traj} thermal trajectories in {wall:.1f} s "
      f"on {jax.device_count()} device(s)\n")

shades = " .:-=+*#%@"
print("P(switch)  duration ->  {:.1e} .. {:.1e} s".format(
    float(durations[0]), float(durations[-1])))
for i, row in enumerate(p):
    # '?' marks a grid point whose whole ensemble failed (p is NaN there).
    line = "".join(
        "?" if not np.isfinite(v)
        else shades[min(int(v * (len(shades) - 1)), len(shades) - 1)]
        for v in row
    )
    print(f"J={float(currents[i]):+.2e}  |{line}|")

_os.makedirs("results", exist_ok=True)
with open("results/switching_diagram.json", "w") as fh:
    json.dump(
        {
            "currents": np.asarray(currents).tolist(),
            "durations": np.asarray(durations).tolist(),
            # float(): row elements are np.float32, which json rejects.
            "p_switch": [[float(v) if np.isfinite(v) else None for v in row]
                         for row in p],
        },
        fh, indent=2,
    )
print("\nwrote results/switching_diagram.json")
