"""Visualization: publication-style plots over engine outputs.

Counterpart of spin_torque_gym/visualization/research_plots.py. Matplotlib
is imported lazily; nothing here touches the device hot path.
"""

from .plots import (
    SpintronicVisualizer,
    plot_energy_surface,
    plot_switching_diagram,
    plot_trajectory,
)
from .research_plots import QuantumSpintronicVisualizer

__all__ = [
    "SpintronicVisualizer",
    "plot_energy_surface",
    "plot_switching_diagram",
    "plot_trajectory",
    "QuantumSpintronicVisualizer",
]
