"""Fused LLGS pulse kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA path (physics/integrator.py) runs one fused elementwise program per
substep inside a ``lax.while_loop`` that goes to max(n) over the whole batch;
on a GPU every iteration costs a launch and a loop-predicate round trip for
about 60 flops per env. This kernel runs a whole pulse in one launch: one env
per lane, 1-D power-of-two blocks of envs, and each block loops over substeps
up to its own maximum n with the state held in registers.

Thermal noise comes from a counter-based Threefry-2x32 (20 rounds, the same
function as ``jax.random``'s threefry) written into the kernel and keyed by
(seed, global env index, substep, draw), then Box-Muller. Because the key is
the env's GLOBAL index, a batch sharded over devices draws exactly the noise
the unsharded batch draws.

Specializations (enforced by ``pallas_supported``):
  * float32
  * methods 'rk4', 'heun' and 'euler'; noise modes 'reference' and 'physical'

Any finite unit easy axis is covered, scalar (3,) or per-env (B, 3). The
common +z case (every canned device type) compiles a specialized RHS that
skips the axis loads and projection arithmetic; tilted axes take a general
RHS whose op order mirrors physics/llgs.py.

Deterministic results match the XLA path to float32 rounding
(tests/unit/test_pallas_integrator.py). Selection is by platform: the env and
the sweeps use the kernel on a GPU and XLA elsewhere. ``interpret_mode()``
runs the kernel through the Pallas interpreter on any backend, for tests and
the multi-device dry run.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from ..constants import GAMMA, KB_SOLVER, MU0
from ..physics.integrator import IntegratorConfig, substep_counts
from ..physics.llgs import LLGSParams

# Envs per block and warps per block, for the generator sampler and for
# batches too small to fill the card: 4,096 envs in 32-env single-warp
# blocks make 128 blocks, about one per SM of a 132-SM H100.
_BLOCK = 32
_NUM_WARPS = 1
# Batches that fill every SM with these wider blocks take them instead.
_WIDE_BLOCK = 128
_WIDE_WARPS = 4
# SMs assumed where the device does not report ``core_count`` (the CPU, in
# interpret mode): an H100 SXM.
_DEFAULT_SMS = 132

_METHODS = ("euler", "heun", "rk4")

_INTERPRET = contextvars.ContextVar("spintorque_pallas_interpret", default=False)


@contextlib.contextmanager
def interpret_mode():
    """Run the kernel through the Pallas interpreter (any backend).

    The only way to use the kernel off a GPU: tests and the multi-device dry
    run enter it explicitly. Traces made inside stay cached by their jit."""
    token = _INTERPRET.set(True)
    try:
        yield
    finally:
        _INTERPRET.reset(token)


def kernel_platform() -> bool:
    """True where the kernel can run: a GPU backend, or interpret mode."""
    return jax.default_backend() == "gpu" or _INTERPRET.get()


def select_kernel(requested: Optional[bool], supported: bool) -> bool:
    """Resolve a ``use_pallas`` request against the observed platform.

    None selects the kernel where it can run (a GPU, or inside
    ``interpret_mode()``) and covers the configuration, and XLA elsewhere.
    True insists on the kernel and raises where it cannot run or does not
    cover the configuration; False keeps XLA."""
    if requested is None:
        return bool(supported and kernel_platform())
    if not requested:
        return False
    if not kernel_platform():
        raise RuntimeError(
            "use_pallas=True needs a GPU backend (found "
            f"{jax.default_backend()!r}); use interpret_mode() to run the "
            "kernel through the Pallas interpreter"
        )
    if not supported:
        raise ValueError(
            "use_pallas=True, but the kernel does not cover this configuration "
            "(float32, methods euler/heun/rk4, finite nonzero easy axis)"
        )
    return True


def pallas_supported(params: LLGSParams, config: IntegratorConfig, dtype) -> bool:
    """Whether the fast kernel covers this configuration (concrete params)."""
    if config.method not in _METHODS:
        return False
    if jnp.dtype(dtype) != jnp.float32:
        return False
    try:
        e = np.asarray(params.easy_axis)
    except jax.errors.TracerArrayConversionError:  # traced axis: cannot decide
        return False
    norm = np.linalg.norm(np.atleast_2d(e), axis=-1)
    return bool(np.all(np.isfinite(e)) and np.all(norm > 1e-12))


def _is_plus_z(easy_axis) -> bool:
    """True when every easy axis is exactly +z (specialized RHS applies).

    Returns False for traced axes (conservative: general RHS is used)."""
    try:
        e = np.asarray(easy_axis)
    except jax.errors.TracerArrayConversionError:
        return False
    e = np.atleast_2d(e)
    return bool(
        np.all(np.abs(e[..., 0]) < 1e-12)
        and np.all(np.abs(e[..., 1]) < 1e-12)
        and np.all(e[..., 2] > 0)
    )


# ------------------------------------------------------------------ generator

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return lax.shift_left(x, np.uint32(r)) | lax.shift_right_logical(
        x, np.uint32(32 - r)
    )


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays: ``jax.random``'s hash.

    Needs only uint32 add, shift, or and xor, so it runs inside the kernel
    as well as in plain XLA."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for r in range(5):
        for s in _ROTATIONS[r % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, s) ^ x0
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return x0, x1


def _uniform(bits):
    """Uniform [0, 1) float32 from the top 23 bits (mantissa bitcast)."""
    mant = lax.shift_right_logical(bits, np.uint32(9)) | np.uint32(0x3F800000)
    return lax.bitcast_convert_type(mant, jnp.float32) - 1.0


def normal_pair(k0, k1, x0, x1):
    """Two independent standard normals per lane from one Threefry block:
    exact Box-Muller (no tail truncation; the Neel-Brown gate checks it)."""
    b0, b1 = threefry2x32(k0, k1, x0, x1)
    u1 = 1.0 - _uniform(b0)  # (0, 1]: safe for log
    theta = (2.0 * np.pi) * _uniform(b1)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    return r * jnp.cos(theta), r * jnp.sin(theta)


def fields_per_substep(config: IntegratorConfig) -> int:
    """Thermal field realizations per substep: one per RK4 stage under
    rk4_noise='per_stage', else one."""
    return 4 if (config.method == "rk4" and config.rk4_noise == "per_stage") else 1


def draws_per_substep(config: IntegratorConfig) -> int:
    """Threefry blocks per substep: two normals each, three per field."""
    return (3 * fields_per_substep(config) + 1) // 2


def substep_normals(k0, k1, i, config: IntegratorConfig):
    """The standard normals of substep ``i`` for envs keyed (k0, k1):
    a list of (nx, ny, nz) per field, in the kernel's draw order."""
    n_draw = draws_per_substep(config)
    vals = []
    step = lax.convert_element_type(i, jnp.uint32) * np.uint32(n_draw)
    for d in range(n_draw):
        a, b = normal_pair(k0, k1, jnp.zeros_like(k0) + step + np.uint32(d),
                           jnp.zeros_like(k0))
        vals += [a, b]
    return [tuple(vals[3 * f:3 * f + 3]) for f in range(fields_per_substep(config))]


def env_keys(key, env_index):
    """Per-env Threefry key words from the step key and GLOBAL env indices."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    kd = jnp.asarray(key, jnp.uint32).reshape(-1)
    idx = jnp.asarray(env_index, jnp.uint32)
    return threefry2x32(kd[0], kd[1], idx, jnp.zeros_like(idx))


def sample_kernel_normals(config: IntegratorConfig, key, batch: int, substeps: int = 2):
    """The kernel's own thermal normals for substeps [0, substeps) of
    ``batch`` envs, drawn inside a kernel exactly as the integrator draws
    them: (substeps, fields per substep, 3, batch). For checking the
    generator where it runs; ``batch`` is a multiple of the block size."""
    if batch % _BLOCK:
        raise ValueError(f"batch {batch} is not a multiple of {_BLOCK}")
    n_fields = fields_per_substep(config)
    n_out = substeps * n_fields * 3
    k0, k1 = env_keys(key, jnp.arange(batch, dtype=jnp.uint32))

    def kern(k0_ref, k1_ref, *out_refs):
        k0, k1 = k0_ref[...], k1_ref[...]
        vals = [c for i in range(substeps)
                for field in substep_normals(k0, k1, i, config) for c in field]
        for ref, v in zip(out_refs, vals):
            ref[...] = v

    spec = pl.BlockSpec((_BLOCK,), lambda b: (b,))
    outs = pl.pallas_call(
        kern,
        grid=(batch // _BLOCK,),
        in_specs=[spec, spec],
        out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((batch,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=_INTERPRET.get(),
        name="llgs_noise_sample",
    )(k0, k1)
    return jnp.stack(outs).reshape(substeps, n_fields, 3, batch)


# --------------------------------------------------------------------- kernel

def _kernel(*refs, config: IntegratorConfig, easy_z: bool):
    method, thermal = config.method, config.thermal
    n_in = 10 + (3 if thermal else 0) + (0 if easy_z else 3)
    vals = [r[...] for r in refs[:n_in]]
    ox_ref, oy_ref, oz_ref, failed_ref = refs[n_in:]
    mx0, my0, mz0, dt, n, h_k, ms, gamma_eff, alpha, stt = vals[:10]
    rest = vals[10:]
    if thermal:
        sigma, k0, k1 = rest[:3]
        rest = rest[3:]
    if not easy_z:
        ex, ey, ez = rest

    def rhs(mx, my, mz, noise):
        """dm/dt; op order mirrors physics/llgs.py."""
        nx, ny, nz = noise
        if easy_z:
            anis = h_k * mz
            hx = 0.0 + nx
            hy = 0.0 + ny
            hz = anis - ms * mz + nz
            # u = m x z = (my, -mx, 0); v = m x u
            ux = my
            uy = -mx
            vx = -(mz * uy)
            vy = mz * ux
            vz = mx * uy - my * ux
        else:
            anis = h_k * (mx * ex + my * ey + mz * ez)
            hx = anis * ex + nx
            hy = anis * ey + ny
            hz = anis * ez - ms * mz + nz
            ux = my * ez - mz * ey
            uy = mz * ex - mx * ez
            uz = mx * ey - my * ex
            vx = my * uz - mz * uy
            vy = mz * ux - mx * uz
            vz = mx * uy - my * ux
        px = my * hz - mz * hy
        py = mz * hx - mx * hz
        pz = mx * hy - my * hx
        dx = my * pz - mz * py
        dy = mz * px - mx * pz
        dz = mx * py - my * px
        return (
            -gamma_eff * (px + alpha * dx) + stt * vx,
            -gamma_eff * (py + alpha * dy) + stt * vy,
            -gamma_eff * (pz + alpha * dz) + stt * vz,
        )

    zero = (0.0, 0.0, 0.0)

    def step(i, mx, my, mz):
        if thermal:
            fields = [
                (sigma * a, sigma * b, sigma * c)
                for a, b, c in substep_normals(k0, k1, i, config)
            ]
        else:
            fields = [zero]
        if method == "euler":
            fx, fy, fz = rhs(mx, my, mz, fields[0])
            return mx + dt * fx, my + dt * fy, mz + dt * fz
        if method == "heun":
            fx, fy, fz = rhs(mx, my, mz, fields[0])
            gx, gy, gz = rhs(mx + dt * fx, my + dt * fy, mz + dt * fz, fields[0])
            return (
                mx + 0.5 * dt * (fx + gx),
                my + 0.5 * dt * (fy + gy),
                mz + 0.5 * dt * (fz + gz),
            )
        st = [fields[min(s, len(fields) - 1)] for s in range(4)]
        k1x, k1y, k1z = rhs(mx, my, mz, st[0])
        k1x, k1y, k1z = dt * k1x, dt * k1y, dt * k1z
        k2x, k2y, k2z = rhs(mx + k1x / 2, my + k1y / 2, mz + k1z / 2, st[1])
        k2x, k2y, k2z = dt * k2x, dt * k2y, dt * k2z
        k3x, k3y, k3z = rhs(mx + k2x / 2, my + k2y / 2, mz + k2z / 2, st[2])
        k3x, k3y, k3z = dt * k3x, dt * k3y, dt * k3z
        k4x, k4y, k4z = rhs(mx + k3x, my + k3y, mz + k3z, st[3])
        k4x, k4y, k4z = dt * k4x, dt * k4y, dt * k4z
        return (
            mx + (k1x + 2 * k2x + 2 * k3x + k4x) / 6,
            my + (k1y + 2 * k2y + 2 * k3y + k4y) / 6,
            mz + (k1z + 2 * k2z + 2 * k3z + k4z) / 6,
        )

    def normalize(mx, my, mz):
        """physics/llgs.normalize_with_fallback."""
        norm = jnp.sqrt(mx * mx + my * my + mz * mz)
        finite = jnp.isfinite(mx) & jnp.isfinite(my) & jnp.isfinite(mz)
        ok = finite & (norm >= 1e-12)
        safe = jnp.where(ok, norm, 1.0)
        nx, ny, nz = mx / safe, my / safe, mz / safe
        ok = ok & jnp.isfinite(nx) & jnp.isfinite(ny) & jnp.isfinite(nz)
        return jnp.where(ok, nx, 0.0), jnp.where(ok, ny, 0.0), jnp.where(ok, nz, 1.0)

    def body(i, carry):
        # ``failed`` is an int32 carry: boolean vectors as loop carries are
        # avoided on every lowering.
        mx, my, mz, failed = carry
        nx, ny, nz = normalize(*step(i, mx, my, mz))
        active = i < n
        zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        return (
            jnp.where(active, nx, mx),
            jnp.where(active, ny, my),
            jnp.where(active, nz, mz),
            jnp.maximum(failed, zero_row.astype(jnp.int32)),
        )

    init = (mx0, my0, mz0, jnp.zeros(mx0.shape, jnp.int32))
    mx, my, mz, failed = lax.fori_loop(0, jnp.max(n), body, init)
    ox_ref[...] = mx
    oy_ref[...] = my
    oz_ref[...] = mz
    failed_ref[...] = failed


def integrate_pulse_pallas(
    m0: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    span: jnp.ndarray,
    current: jnp.ndarray,
    params: LLGSParams,
    config: IntegratorConfig,
    key: Optional[jax.Array] = None,
    temperature: jnp.ndarray | float = 300.0,
    *,
    mesh=None,
    data_axis: str = "data",
):
    """Drop-in fast path for physics.integrator.integrate_pulse.

    Returns (mx, my, mz), n_substeps, dt, failed - same semantics as
    PulseResult fields. Requires pallas_supported(...) conditions.

    The +z-axis RHS specialization is resolved HERE, outside jit, where the
    easy axis is still a concrete array; callers inside an outer jit get the
    general RHS (correct for every axis).

    ``mesh``: when the batch is sharded over a multi-device mesh, pass the
    mesh so the kernel runs per shard under shard_map and no batch data
    crosses devices. Noise is keyed by the global env index, so sharded and
    unsharded runs agree bitwise.
    """
    if config.thermal and key is None:
        raise ValueError("integrate_pulse_pallas: thermal=True requires a PRNG key")
    easy_z = _is_plus_z(params.easy_axis)
    interpret = _INTERPRET.get()
    n_data = dict(mesh.shape).get(data_axis, 1) if mesh is not None else 1
    B = jnp.shape(m0[0])[0]
    # shard_map requires B % n_data == 0. Such batches are replicated by
    # parallel.shard_env_state, so they take the plain path.
    if n_data > 1 and B % n_data == 0:
        return _integrate_pulse_pallas_sharded(
            m0, span, current, params, config, key, temperature,
            easy_z=easy_z, interpret=interpret, mesh=mesh, data_axis=data_axis,
        )
    return _integrate_pulse_pallas(
        m0, span, current, params, config, key, temperature,
        easy_z=easy_z, interpret=interpret,
    )


def _prep_operands(m0, span, current, params, config, key, temperature, easy_z):
    """Every per-env kernel operand as a (B,) array, over the GLOBAL batch:
    elementwise work that partitions with the batch."""
    dtype = jnp.float32
    mx0, my0, mz0 = (jnp.asarray(c, dtype) for c in m0)
    B = mx0.shape[0]

    def bcast(x):
        return jnp.broadcast_to(jnp.asarray(x, dtype), (B,))

    span = bcast(span)
    current = bcast(current)
    ms = bcast(params.saturation_magnetization)
    alpha = bcast(params.damping)
    k_u = bcast(params.uniaxial_anisotropy)
    vol = bcast(params.volume)
    pol = bcast(params.polarization)

    dt, n = substep_counts(span, config.max_step)
    n = jnp.minimum(n, config.max_substeps)
    dt = span / n.astype(dtype)  # full-span integration when n is clamped

    h_k = (2.0 * k_u) / (MU0 * ms)
    gamma_eff = GAMMA / (1.0 + alpha**2)
    stt = pol * current / (ms * vol)
    stt = jnp.where(jnp.abs(current) > 1e-12, stt, 0.0)
    arrays = [mx0, my0, mz0, dt, n, h_k, ms, gamma_eff, alpha, stt]

    if config.thermal:
        if config.noise_mode not in ("reference", "physical"):
            raise ValueError(f"Unknown noise_mode: {config.noise_mode}")
        if config.rk4_noise not in ("per_stage", "per_substep"):
            raise ValueError(f"Unknown rk4_noise: {config.rk4_noise}")
        temp = bcast(temperature)
        denom = MU0 * ms * vol * GAMMA
        if config.noise_mode == "physical":
            sigma = jnp.sqrt(2.0 * alpha * KB_SOLVER * temp / (denom * dt))
        else:
            sigma = jnp.sqrt(2.0 * alpha * KB_SOLVER * temp / denom)
        sigma = jnp.where(temp > 0.0, sigma, 0.0)
        k0, k1 = env_keys(key, jnp.arange(B, dtype=jnp.uint32))
        arrays += [sigma, k0, k1]
    if not easy_z:
        exn, eyn, ezn = params.normalized_easy_axis()
        arrays += [bcast(exn), bcast(eyn), bcast(ezn)]
    return tuple(arrays)


@functools.partial(jax.jit, static_argnames=("config", "easy_z", "interpret"))
def _integrate_pulse_pallas(
    m0, span, current, params, config, key=None, temperature=300.0,
    *, easy_z=True, interpret=False,
):
    arrays = _prep_operands(m0, span, current, params, config, key, temperature, easy_z)
    return _pallas_core(arrays, config=config, easy_z=easy_z, interpret=interpret)


@functools.partial(
    jax.jit, static_argnames=("config", "easy_z", "interpret", "mesh", "data_axis")
)
def _integrate_pulse_pallas_sharded(
    m0, span, current, params, config, key, temperature,
    *, easy_z, interpret, mesh, data_axis,
):
    """The kernel per shard of the 'data' axis: no data collective, and
    the same per-env noise keys as the unsharded batch (they are derived
    from global indices before the shard_map)."""
    from jax.sharding import PartitionSpec as P

    arrays = _prep_operands(m0, span, current, params, config, key, temperature, easy_z)

    def body(arrs):
        return _pallas_core(arrs, config=config, easy_z=easy_z, interpret=interpret)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(data_axis),),
        out_specs=((P(data_axis),) * 3, P(data_axis), P(data_axis), P(data_axis)),
        check_vma=False,
    )(arrays)


def _sm_count() -> int:
    """Streaming multiprocessors of the default device."""
    return int(getattr(jax.devices()[0], "core_count", 0) or _DEFAULT_SMS)


def launch_shape(batch: int, n_sm: int) -> Tuple[int, int, bool]:
    """(envs per block, warps per block, sort by duration) for ``batch``.

    While the blocks fit on the SMs at once, a step lasts as long as its
    longest block whatever the order, so narrow blocks and no sort are
    fastest. Once blocks queue for SMs, sorting envs by descending substep
    count lets each block stop at its own bound and cuts the total work
    toward sum(n) from blocks * max(n); batches that fill every SM with
    wide blocks take those too. Measured on an H100 (PERF.md): at B=4096
    the sort costs 1-3%, at B=65536 it gains 40-56%."""
    if batch >= _WIDE_BLOCK * n_sm:
        return _WIDE_BLOCK, _WIDE_WARPS, True
    return _BLOCK, _NUM_WARPS, -(-batch // _BLOCK) > n_sm


def _pallas_core(arrays, *, config: IntegratorConfig, easy_z: bool, interpret: bool):
    """Sort (when it pays), pad to whole blocks, run the kernel, and undo
    both. ``arrays`` is the (B,) operand tuple of _prep_operands (the local
    batch under shard_map)."""
    n, dt = arrays[4], arrays[3]
    B = n.shape[0]
    block, warps, sort = launch_shape(B, _sm_count())
    if sort:
        perm = jnp.argsort(-n)
        # Inverse permutation by one scatter (cheaper than a second sort).
        inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(B, dtype=perm.dtype))
        arrays = tuple(a[perm] for a in arrays)
    Bp = -(-B // block) * block
    # Padded lanes have n = 0, so they never run and never raise a block's
    # bound; the fills keep their (unused) arithmetic finite.
    fills = {2: 1.0, 3: 1.0, 6: 1.0}

    def pad(i, x):
        return jnp.pad(x, (0, Bp - B), constant_values=fills.get(i, 0))

    args = [pad(i, x) for i, x in enumerate(arrays)]
    spec = pl.BlockSpec((block,), lambda b: (b,))
    kernel = functools.partial(_kernel, config=config, easy_z=easy_z)
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=[spec] * len(args),
        out_specs=[spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((Bp,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((Bp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="llgs_pulse",
    )(*args)
    ox, oy, oz, failed = (o[:B] for o in outs)
    if sort:
        ox, oy, oz, failed = (o[inv] for o in (ox, oy, oz, failed))
    return (ox, oy, oz), n, dt, failed.astype(bool)
