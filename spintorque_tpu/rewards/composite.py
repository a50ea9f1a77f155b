"""Composite reward: weighted, normalized, clipped component sum.

Counterpart of the reference CompositeReward
(spin_torque_gym/rewards/composite_reward.py:14-314). Components are pure
batched functions fused into the jitted env step. The reference's running
normalization over a Python history list becomes an explicit running-moments
pytree carried in the environment state (Welford update, per-env), so
'running_mean' / 'running_std' / 'unit_range' modes stay jit-compatible.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
from .. import struct

from .components import RewardContext, resolve


@struct.dataclass
class RunningStat:
    """Per-env running moments of one reward component."""

    count: Any  # (B,)
    mean: Any  # (B,)
    m2: Any  # (B,) sum of squared deviations
    min: Any  # (B,)
    max: Any  # (B,)

    @classmethod
    def create(cls, batch: int, dtype=jnp.float32) -> "RunningStat":
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        return cls(
            count=jnp.zeros((batch,), dtype),
            mean=jnp.zeros((batch,), dtype),
            m2=jnp.zeros((batch,), dtype),
            min=jnp.full((batch,), big),
            max=jnp.full((batch,), -big),
        )

    def update(self, value) -> "RunningStat":
        count = self.count + 1.0
        delta = value - self.mean
        mean = self.mean + delta / count
        m2 = self.m2 + delta * (value - mean)
        return RunningStat(
            count=count,
            mean=mean,
            m2=m2,
            min=jnp.minimum(self.min, value),
            max=jnp.maximum(self.max, value),
        )

    def std(self):
        return jnp.sqrt(self.m2 / jnp.maximum(self.count, 1.0))


class CompositeReward:
    """Static composite-reward configuration + pure compute function.

    components: {name: {'weight': float, 'function': callable|registry-name,
                        'normalize': None|'running_mean'|'running_std'|
                                     'unit_range'|{'mean','std'}|{'min','max'},
                        'clip': None|(lo, hi)}}
    """

    def __init__(self, components: Dict[str, Dict[str, Any]]):
        self.components = {}
        self.total_weight = 0.0
        for name, config in components.items():
            self._add(name, config)

    def _add(self, name: str, config: Dict[str, Any]) -> None:
        if "weight" not in config:
            raise ValueError(f"Component '{name}' missing required 'weight'")
        if "function" not in config:
            raise ValueError(f"Component '{name}' missing required 'function'")
        self.components[name] = {
            "weight": float(config["weight"]),
            "function": resolve(config["function"]),
            "normalize": config.get("normalize", None),
            "clip": config.get("clip", None),
        }
        self.total_weight += abs(float(config["weight"]))

    # --- dynamic reconfiguration (composite_reward.py:241-298) ---
    def add_component(self, name, weight, function, normalize=None, clip=None):
        self._add(name, {"weight": weight, "function": function,
                         "normalize": normalize, "clip": clip})

    def remove_component(self, name: str) -> None:
        if name in self.components:
            self.total_weight -= abs(self.components[name]["weight"])
            del self.components[name]

    def update_weight(self, name: str, new_weight: float) -> None:
        if name not in self.components:
            raise ValueError(f"Component '{name}' not found")
        self.total_weight -= abs(self.components[name]["weight"])
        self.components[name]["weight"] = float(new_weight)
        self.total_weight += abs(new_weight)

    def get_component_names(self):
        return list(self.components)

    @property
    def needs_stats(self) -> bool:
        return any(
            isinstance(c["normalize"], str) for c in self.components.values()
        )

    def init_stats(self, batch: int, dtype=jnp.float32) -> Dict[str, RunningStat]:
        return {
            name: RunningStat.create(batch, dtype)
            for name, c in self.components.items()
            if isinstance(c["normalize"], str)
        }

    def compute(
        self,
        ctx: RewardContext,
        stats: Optional[Dict[str, RunningStat]] = None,
    ) -> Tuple[Any, Dict[str, Any], Dict[str, RunningStat]]:
        """Returns (total (B,), per-component dict, updated stats).

        Normalization semantics follow composite_reward.py:128-187:
        running_mean subtracts the running mean, running_std standardizes,
        unit_range maps into [0, 1] by running min/max, and dict configs use
        explicit constants. Matching the reference's ordering (:96-121): a
        value is normalized against the PRE-update history, and the history
        then absorbs the post-normalize post-clip value.
        """
        stats = dict(stats or {})
        total = None
        breakdown: Dict[str, Any] = {}
        for name, c in self.components.items():
            value = c["function"](ctx)
            norm = c["normalize"]
            needs_stat_update = False
            if isinstance(norm, str):
                st = stats[name]
                has_history = st.count > 0
                if norm == "running_mean":
                    value = jnp.where(has_history, value - st.mean, value)
                elif norm == "running_std":
                    has2 = st.count > 1
                    value = jnp.where(
                        has2, (value - st.mean) / (st.std() + 1e-8), value
                    )
                elif norm == "unit_range":
                    span = st.max - st.min
                    value = jnp.where(
                        has_history & (span > 0), (value - st.min) / span, value
                    )
                else:
                    raise ValueError(f"Unknown normalization method: {norm}")
                needs_stat_update = True
            elif isinstance(norm, dict):
                if "mean" in norm and "std" in norm:
                    value = (value - norm["mean"]) / (norm["std"] + 1e-8)
                elif "min" in norm and "max" in norm:
                    if norm["max"] > norm["min"]:
                        value = (value - norm["min"]) / (norm["max"] - norm["min"])
                else:
                    raise ValueError(f"Invalid normalization config: {norm}")
            if c["clip"] is not None:
                lo, hi = c["clip"]
                value = jnp.clip(value, lo, hi)
            if needs_stat_update:
                stats[name] = stats[name].update(value)
            weighted = c["weight"] * value
            breakdown[name] = value
            total = weighted if total is None else total + weighted
        if total is None:
            total = jnp.zeros_like(ctx.alignment)
        return total, breakdown, stats

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{n}: weight={c['weight']:.3f}" for n, c in self.components.items()
        )
        return f"CompositeReward({parts})"
