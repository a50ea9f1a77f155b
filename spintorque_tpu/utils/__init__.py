"""Foundation utilities: monitoring, safety, validation, errors, profiling,
logging, checkpointing, caching, concurrency, scaling, health.

Counterpart of spin_torque_gym/utils (__init__.py:7-23). The reference's
three overlapping cache stacks collapse into ONE host-side stack
(utils/cache.py) - device compute is never cached (jit compilation caching
replaces memoization, and the reference's result caches were bug sources:
current-blind solver cache, stale observation cache - see SURVEY.md). The
thread/process-pool tier is kept surface-compatible but accelerator-shaped:
PhysicsWorkerPool COALESCES submissions into batched device calls,
AutoScaler tunes the batch size (the chip's real thread count), and
first-class scale-out remains the mesh sharding in spintorque_tpu.parallel.
"""

from .cache import (
    AdaptiveCache,
    CacheManager,
    CacheStats,
    LRUCache,
    cached,
    get_cache_manager,
)

from .checkpoint import (
    CheckpointManager,
    load_params,
    load_pytree,
    save_params,
    save_pytree,
)
from .error_handling import (
    ConfigurationError,
    DeviceError,
    ErrorRecoveryManager,
    NumericalError,
    PhysicsError,
    SpinTorqueError,
    robust_computation,
    safe_division,
    safe_execute,
    safe_log,
    safe_normalize,
    safe_sqrt,
)
from .logging_config import (
    LoggingContext,
    PerformanceLogger,
    StructuredFormatter,
    get_logger,
    setup_logging,
)
from .concurrency import (
    AsyncEnvironmentManager,
    ParallelBenchmark,
    PhysicsWorkerPool,
    ResourcePool,
    parallel_map,
)
from .health import (
    DeviceHealthCheck,
    EnvironmentHealthCheck,
    HealthCheck,
    PhysicsHealthCheck,
    SystemHealthCheck,
    build_full_health_monitor,
    get_health_monitor,
)
from .monitoring import (
    EnvironmentMonitor,
    HealthMonitor,
    MetricsCollector,
    SafetyWrapper,
    default_health_monitor,
)
from .performance import (
    ComputationOptimizer,
    get_optimizer,
    pad_batch,
    unpad_batch,
)
from .profiling import PerformanceProfiler, block_and_time, device_trace
from .scalable_environment import ScalableEnvironmentManager
from .scaling import AdaptiveResourceManager, AutoScaler, LoadBalancer
from .security import (
    InputSanitizer,
    RateLimiter,
    SecureHasher,
    SecurityAuditor,
    SecurityError,
)
from .validation import (
    ActionValidator,
    NumericalValidator,
    PhysicsValidator,
    ValidationError,
    validate_action,
    validate_environment_config,
    validate_magnetization,
    validate_observation,
    validate_parameters,
)

__all__ = [
    "AdaptiveCache",
    "CacheManager",
    "CacheStats",
    "LRUCache",
    "cached",
    "get_cache_manager",
    "AsyncEnvironmentManager",
    "ParallelBenchmark",
    "PhysicsWorkerPool",
    "ResourcePool",
    "parallel_map",
    "DeviceHealthCheck",
    "EnvironmentHealthCheck",
    "HealthCheck",
    "PhysicsHealthCheck",
    "SystemHealthCheck",
    "build_full_health_monitor",
    "get_health_monitor",
    "ComputationOptimizer",
    "get_optimizer",
    "pad_batch",
    "unpad_batch",
    "ScalableEnvironmentManager",
    "AdaptiveResourceManager",
    "AutoScaler",
    "LoadBalancer",

    "CheckpointManager",
    "load_params",
    "load_pytree",
    "save_params",
    "save_pytree",
    "ConfigurationError",
    "DeviceError",
    "ErrorRecoveryManager",
    "NumericalError",
    "PhysicsError",
    "SpinTorqueError",
    "robust_computation",
    "safe_division",
    "safe_execute",
    "safe_log",
    "safe_normalize",
    "safe_sqrt",
    "LoggingContext",
    "PerformanceLogger",
    "StructuredFormatter",
    "get_logger",
    "setup_logging",
    "EnvironmentMonitor",
    "HealthMonitor",
    "MetricsCollector",
    "SafetyWrapper",
    "default_health_monitor",
    "PerformanceProfiler",
    "block_and_time",
    "device_trace",
    "InputSanitizer",
    "RateLimiter",
    "SecureHasher",
    "SecurityAuditor",
    "SecurityError",
    "ActionValidator",
    "NumericalValidator",
    "PhysicsValidator",
    "ValidationError",
    "validate_action",
    "validate_environment_config",
    "validate_magnetization",
    "validate_observation",
    "validate_parameters",
]
