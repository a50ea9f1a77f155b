"""Quantum add-on tier: state-vector simulation, QAOA/VQE optimizers,
surface-code error correction, hybrid scheduling, benchmark/verification.

Accelerator-native counterpart of the reference's quantum/ package (SURVEY.md
section 2.8, ~7k LoC of per-amplitude NumPy loops). Everything here runs as
jitted batch programs: gates are real tensordots, Monte-Carlo error trials
are GF(2) matmuls, and variational optimizers use exact autodiff gradients.
The reference's unreproducible performance claims (SURVEY.md section 6) are
NOT reproduced; quantum/advantage_verification.py provides the honest
statistical harness for making such claims instead.
"""

from .advantage_verification import (
    AdvantageReport,
    PerformanceAnalytics,
    QuantumAdvantageVerifier,
)
from .benchmarking import (
    QuantumBenchmarkSuite,
    create_standard_benchmark_suite,
)
from .circuits import CircuitOptimizer, Gate, HardwareCompiler, QuantumCircuit
from .energy_landscape import QuantumEnhancedEnergyLandscape, SymmetryEnhancedVQE
from .error_correction import (
    LogicalQubitOperations,
    SkyrmionErrorCorrection,
    SurfaceCodeErrorCorrection,
    TopologicalProtection,
)
from .hybrid_computing import (
    AdaptiveResourceOptimizer,
    AdaptiveScheduler,
    HybridMultiDeviceSimulator,
    ProgrammableQuantumSimulator,
    SimulationTask,
)
from .optimization import (
    IterationFreeQAOA,
    OptimizationResult,
    QuantumMLDeviceOptimizer,
)

__all__ = [
    "AdvantageReport",
    "PerformanceAnalytics",
    "QuantumAdvantageVerifier",
    "QuantumBenchmarkSuite",
    "create_standard_benchmark_suite",
    "CircuitOptimizer",
    "Gate",
    "HardwareCompiler",
    "QuantumCircuit",
    "QuantumEnhancedEnergyLandscape",
    "SymmetryEnhancedVQE",
    "LogicalQubitOperations",
    "SkyrmionErrorCorrection",
    "SurfaceCodeErrorCorrection",
    "TopologicalProtection",
    "AdaptiveResourceOptimizer",
    "AdaptiveScheduler",
    "HybridMultiDeviceSimulator",
    "ProgrammableQuantumSimulator",
    "SimulationTask",
    "IterationFreeQAOA",
    "OptimizationResult",
    "QuantumMLDeviceOptimizer",
]
