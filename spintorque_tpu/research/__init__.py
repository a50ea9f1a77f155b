"""Research tooling: parameter optimization, benchmarking, validation.

Honest counterpart of the reference's research/quantum add-on tier
(SURVEY.md section 2.8). The reference ships ~10k LoC of classical NumPy
simulations under quantum branding with unreproducible performance claims;
this module provides the same *capabilities* - device-parameter
optimization, protocol search, benchmark suites, statistical validation,
policy comparison - as classical population methods whose populations
evaluate in single vmapped physics calls on the accelerator.
"""

from .sweeps import (
    parameter_ladder_sweep,
    switching_probability_diagram,
)
from .comparative_algorithms import (
    ComparativeAnalysis,
    OptimalControlBaseline,
    PhysicsInformedRL,
    run_comprehensive_benchmark,
)
from .novel_algorithms import (
    AdaptiveMetaLearner,
    Hypothesis,
    HypothesisDrivenExperimentEngine,
    QuantumInspiredSpintronicOptimizer,
)
from .publication_framework import (
    FigureGenerator,
    PublicationFramework,
    StatisticalAnalyzer,
)
from .quantum_machine_learning import (
    QuantumNeuralNetwork,
    QuantumReinforcementLearning,
    QuantumSpinOptimizer,
)
from .quantum_spintronics import (
    QuantumSpintronicBenchmark,
    QuantumSpintronicOptimizer,
)
from .validation_framework import (
    QuantumValidationFramework,
    ResearchValidationFramework,
    ValidationCheck,
)
from .benchmarking import (
    BenchmarkResult,
    BenchmarkSuite,
    bootstrap_ci,
    compare_policies,
    create_standard_benchmark_suite,
    significance_test,
)
from .optimizers import (
    OptimizationResult,
    cross_entropy,
    grid_search,
    optimize_switching_pulse,
    simulated_annealing,
    switching_objective,
)

__all__ = [
    "ComparativeAnalysis",
    "OptimalControlBaseline",
    "PhysicsInformedRL",
    "run_comprehensive_benchmark",
    "parameter_ladder_sweep",
    "switching_probability_diagram",
    "AdaptiveMetaLearner",
    "Hypothesis",
    "HypothesisDrivenExperimentEngine",
    "QuantumInspiredSpintronicOptimizer",
    "FigureGenerator",
    "PublicationFramework",
    "StatisticalAnalyzer",
    "QuantumNeuralNetwork",
    "QuantumReinforcementLearning",
    "QuantumSpinOptimizer",
    "QuantumSpintronicBenchmark",
    "QuantumSpintronicOptimizer",
    "QuantumValidationFramework",
    "ResearchValidationFramework",
    "ValidationCheck",

    "BenchmarkResult",
    "BenchmarkSuite",
    "bootstrap_ci",
    "compare_policies",
    "create_standard_benchmark_suite",
    "significance_test",
    "OptimizationResult",
    "cross_entropy",
    "grid_search",
    "optimize_switching_pulse",
    "simulated_annealing",
    "switching_objective",
]
