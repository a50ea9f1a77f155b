"""Rehearsal of chip_smoke.py on the CPU: every phase at a tiny size with
the kernel in interpret mode, and the refusal to run without a GPU."""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke  # noqa: E402
from spintorque_tpu.ops import interpret_mode  # noqa: E402

TINY = dict(max_substeps=32)


def test_refuses_without_gpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = chip_smoke.main([])
    assert rc != 0
    assert '"ok"' not in out.getvalue()


def test_phase_compile_tiny():
    with interpret_mode():
        lines = chip_smoke.phase_compile(sizes=(64,), **TINY)
    assert len(lines) == 2 and all("memory_analysis" in ln for ln in lines)


def test_phase_deterministic_tiny():
    with interpret_mode():
        lines = chip_smoke.phase_deterministic(B=64, max_substeps=64, max_duration=5e-11)
    assert len(lines) == 4 and all(ln.endswith("pass") for ln in lines)


def test_phase_thermal_noise_tiny():
    with interpret_mode():
        lines = chip_smoke.phase_thermal(noise_batch=2048, full_gates=False)
    assert len(lines) == 2 and all(ln.endswith("pass") for ln in lines)


def test_phase_timing_and_ppo_tiny():
    with interpret_mode():
        lines = chip_smoke.phase_timing("cpu rehearsal", sizes=(64,), compiles=1,
                                        warmup=1, blocks=1, **TINY)
        assert len(lines) == 4 and all("[cpu rehearsal]" in ln for ln in lines)
        lines = chip_smoke.phase_ppo("cpu rehearsal", B=64, hidden=(16, 16), rollout=4,
                                     minibatches=2, steps=1, **TINY)
    assert "train env-steps/s" in lines[-1]


def test_phase_four_on_virtual_devices(monkeypatch):
    """Sharded vs one device, with the launch shapes differing between the
    two (one 'SM': the 256-env batch takes wide sorted blocks unsharded and
    narrow sorted ones per 64-env shard)."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 (virtual) devices")
    from spintorque_tpu.ops import pallas_integrator as pi

    monkeypatch.setattr(pi, "_sm_count", lambda: 1)
    assert pi.launch_shape(256, 1) != pi.launch_shape(64, 1)
    jax.clear_caches()  # no kernel traced under another launch shape
    with interpret_mode():
        lines = chip_smoke.phase_four(n_cards=4, sizes=(64, 256), steps=2,
                                      ppo_hidden=(16, 16), ppo_rollout=4, **TINY)
    assert sum("bitwise equal: True" in ln for ln in lines) == 4
    assert sum(ln.endswith("pass") for ln in lines) == 2
