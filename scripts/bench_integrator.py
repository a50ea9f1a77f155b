"""Integrator micro-benchmark: XLA vs the GPU kernel (run on the GPU)."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time, jax, jax.numpy as jnp, numpy as np
from spintorque_tpu.physics import IntegratorConfig, integrate_pulse
from spintorque_tpu.physics.solver import params_from_dict
p = params_from_dict(dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
    uniaxial_anisotropy=1.2e6, polarization=0.7, easy_axis=np.array([0.,0.,1.])))
B = 4096
key = jax.random.PRNGKey(0)
m = jax.random.normal(key, (B,3), jnp.float32); m = m/jnp.linalg.norm(m,axis=-1,keepdims=True)
m0 = (m[:,0], m[:,1], m[:,2])
spans = jnp.full((B,), 1e-9, jnp.float32)
cur = jnp.full((B,), 1e2, jnp.float32)
def timeit(fn, *args, iters=30):
    r = fn(*args); jax.block_until_ready(r)
    t0=time.perf_counter()
    for _ in range(iters): r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter()-t0)/iters*1e3
for label, cfg, needs_key in [
    ("XLA det rk4     ", IntegratorConfig(method="rk4", max_substeps=1024), False),
    ("PALLAS det rk4  ", IntegratorConfig(method="rk4", max_substeps=1024, use_pallas=True), False),
    ("XLA thermal rk4 ", IntegratorConfig(method="rk4", max_substeps=1024, thermal=True), True),
    ("PALLAS therm rk4", IntegratorConfig(method="rk4", max_substeps=1024, thermal=True, use_pallas=True), True),
]:
    t0c = time.time()
    if needs_key:
        f = jax.jit(lambda m0, k, c=cfg: integrate_pulse(m0, spans, cur, p, c, key=k))
        t = timeit(f, m0, key)
    else:
        f = jax.jit(lambda m0, c=cfg: integrate_pulse(m0, spans, cur, p, c))
        t = timeit(f, m0)
    print(f"{label}: {t:.2f} ms /1000 substeps -> {B/(t/1e3):,.0f} pulse/s (compile {time.time()-t0c-t*0.03:.0f}s)", flush=True)
f1 = jax.jit(lambda m0: integrate_pulse(m0, spans, cur, p, IntegratorConfig(method="rk4", max_substeps=1024)))
f2 = jax.jit(lambda m0: integrate_pulse(m0, spans, cur, p, IntegratorConfig(method="rk4", max_substeps=1024, use_pallas=True)))
r1, r2 = f1(m0), f2(m0)
d = max(float(jnp.max(jnp.abs(r1.m[i]-r2.m[i]))) for i in range(3))
print("max |XLA-pallas| deterministic:", d, flush=True)
for BB in (16384, 65536):
    mb = jax.random.normal(key, (BB,3), jnp.float32); mb = mb/jnp.linalg.norm(mb,axis=-1,keepdims=True)
    sp = jnp.full((BB,), 1e-9, jnp.float32); cb = jnp.full((BB,), 1e2, jnp.float32)
    fb = jax.jit(lambda m0, k, s=sp, c=cb: integrate_pulse(m0, s, c, p, IntegratorConfig(method="rk4", max_substeps=1024, thermal=True, use_pallas=True), key=k))
    t = timeit(fb, (mb[:,0],mb[:,1],mb[:,2]), key, iters=10)
    print(f"PALLAS thermal B={BB}: {t:.2f} ms -> {BB/(t/1e3):,.0f} pulse/s", flush=True)
