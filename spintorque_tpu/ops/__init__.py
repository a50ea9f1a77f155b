"""Hand-written GPU kernels (Pallas, Triton route) for the hottest paths."""

from .pallas_integrator import (
    integrate_pulse_pallas,
    interpret_mode,
    pallas_supported,
    select_kernel,
)

__all__ = ["integrate_pulse_pallas", "interpret_mode", "pallas_supported", "select_kernel"]
