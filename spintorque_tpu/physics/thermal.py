"""Thermal fluctuation models and stability analytics.

Accelerator-native counterpart of the reference ThermalFluctuations
(spin_torque_gym/physics/thermal_model.py). The in-loop thermal *field* lives
in ``integrator.py`` (counter-based threefry, fused into the RHS); this module
provides the analytic/stochastic utilities around it: Brown noise strength,
Neel-Brown switching statistics, retention, stability factors and temperature
sweeps - all batched jnp expressions that broadcast over arrays of devices
and temperatures (replacing the reference's Python loops, e.g. the
temperature sweep at thermal_model.py:274-336).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..constants import GAMMA, KB, MU0

SECONDS_PER_YEAR = 365.25 * 24 * 3600


class ThermalFluctuations:
    """Thermal fluctuation model (thermal_model.py:12-137)."""

    def __init__(
        self,
        temperature: float = 300.0,
        correlation_time: float = 1e-12,
        seed: Optional[int] = None,
    ):
        self.temperature = temperature
        self.correlation_time = correlation_time
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self._previous_noise = jnp.zeros(3)

    def set_temperature(self, temperature: float) -> None:
        self.temperature = temperature

    def _next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    def compute_noise_strength(
        self,
        damping,
        saturation_magnetization,
        volume,
        gamma: float = GAMMA,
    ):
        """Brown's RMS thermal field (thermal_model.py:67-73). Broadcasts."""
        variance = (
            2.0 * damping * KB * self.temperature
            / (gamma * MU0 * saturation_magnetization * volume)
        )
        return jnp.where(self.temperature > 0, jnp.sqrt(variance), 0.0)

    def generate_thermal_field(
        self,
        damping,
        saturation_magnetization,
        volume,
        dt: float,
        gamma: float = GAMMA,
        correlated: bool = True,
        shape: Tuple[int, ...] = (),
    ):
        """White or Ornstein-Uhlenbeck-correlated field draw
        (thermal_model.py:75-137). ``shape`` prefixes batch dims."""
        strength = self.compute_noise_strength(damping, saturation_magnetization, volume, gamma)
        white = jax.random.normal(self._next_key(), shape + (3,))
        if correlated and self.correlation_time > 0:
            decay = jnp.exp(-dt / self.correlation_time)
            prev = jnp.broadcast_to(self._previous_noise, shape + (3,))
            corr = decay * prev + jnp.sqrt(1.0 - decay**2) * white
            self._previous_noise = corr if shape == () else corr.reshape(-1, 3)[0]
            return jnp.asarray(strength)[..., None] * corr if jnp.ndim(strength) else strength * corr
        return jnp.asarray(strength)[..., None] * white if jnp.ndim(strength) else strength * white

    def compute_thermal_barrier(self, anisotropy_constant, volume):
        """Thermal stability factor Delta = K_u V / k_B T (:139-156)."""
        return jnp.where(
            self.temperature > 0,
            anisotropy_constant * volume / (KB * self.temperature),
            jnp.inf,
        )

    def compute_switching_probability(
        self,
        energy_barrier,
        attempt_frequency: float = 1e9,
        measurement_time: float = 1e-9,
    ):
        """Neel-Brown switching probability (:158-183)."""
        rate = attempt_frequency * jnp.exp(-energy_barrier / (KB * self.temperature))
        prob = 1.0 - jnp.exp(-rate * measurement_time)
        return jnp.where(self.temperature > 0, jnp.minimum(prob, 1.0), 0.0)

    def sample_switching_time(
        self, energy_barrier, attempt_frequency: float = 1e9, shape: Tuple[int, ...] = ()
    ):
        """Exponentially distributed switching time samples (:185-207)."""
        rate = attempt_frequency * jnp.exp(-energy_barrier / (KB * self.temperature))
        u = jax.random.uniform(self._next_key(), shape, minval=1e-12, maxval=1.0)
        t = -jnp.log(u) / rate
        return jnp.where(rate > 0, t, jnp.inf)

    def compute_retention_time(
        self, energy_barrier, failure_rate: float = 1e-9, attempt_frequency: float = 1e9
    ):
        """Retention time at a given failure rate (:209-232)."""
        thermal_factor = energy_barrier / (KB * self.temperature)
        t = -jnp.log(failure_rate) / (attempt_frequency * jnp.exp(-thermal_factor))
        return jnp.where(self.temperature > 0, t, jnp.inf)

    def analyze_thermal_stability(self, device_params: dict, time_scale: float = 10.0) -> Dict:
        """Stability report (:234-272). time_scale in years."""
        volume = device_params.get("volume", 1e-24)
        k_u = device_params.get("uniaxial_anisotropy", 1e6)
        energy_barrier = k_u * volume
        delta = self.compute_thermal_barrier(k_u, volume)
        switch_prob = self.compute_switching_probability(
            energy_barrier, measurement_time=time_scale * SECONDS_PER_YEAR
        )
        retention_years = self.compute_retention_time(energy_barrier) / SECONDS_PER_YEAR
        return {
            "thermal_stability_factor": float(delta),
            "energy_barrier_J": float(energy_barrier),
            "energy_barrier_kT": float(energy_barrier / (KB * self.temperature)),
            "switching_probability": float(switch_prob),
            "retention_time_years": float(retention_years),
            "is_thermally_stable": bool(delta > 40),
            "temperature_K": self.temperature,
        }

    def generate_temperature_sweep(
        self, temp_range: Tuple[float, float], device_params: dict, n_points: int = 100
    ) -> Dict:
        """Vectorized temperature sweep (replaces the reference's Python loop
        at thermal_model.py:274-336 with one broadcast evaluation)."""
        temps = jnp.linspace(temp_range[0], temp_range[1], n_points)
        volume = device_params.get("volume", 1e-24)
        k_u = device_params.get("uniaxial_anisotropy", 1e6)
        damping = device_params.get("damping", 0.01)
        ms = device_params.get("saturation_magnetization", 800e3)
        barrier = k_u * volume

        delta = barrier / (KB * temps)
        rate = 1e9 * jnp.exp(-delta)
        switch_prob = jnp.minimum(1.0 - jnp.exp(-rate * SECONDS_PER_YEAR), 1.0)
        retention_years = (-jnp.log(1e-9) / rate) / SECONDS_PER_YEAR
        noise = jnp.sqrt(2.0 * damping * KB * temps / (GAMMA * MU0 * ms * volume))
        return {
            "temperature": temps,
            "thermal_stability_factor": delta,
            "switching_probability": switch_prob,
            "retention_time": retention_years,
            "noise_strength": noise,
        }
