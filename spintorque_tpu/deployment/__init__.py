"""Deployment tooling: multi-host launch, serving health, audit records.

Counterpart of the reference deployment tier
(spin_torque_gym/deployment/global_deployment.py - whose sibling modules
are import-broken, deployment/__init__.py:7-10). Rebuilt as practical accelerator
deployment helpers: pod-slice launch manifests, serving health endpoints,
and compliance/audit record keeping.
"""

from .compliance import (
    REGION_RULES,
    REGIONS,
    STANDARD_POLICY,
    STANDARDS,
    ComplianceFramework,
    GlobalDeploymentManager,
    ProcessingRecord,
    RegionConfig,
    production_readiness,
    validate_region_config,
)
from .manager import (
    AuditRecord,
    ComplianceLog,
    DeploymentManager,
    DeploymentSpec,
    serving_health,
)
from .server import HealthState, ServingEndpoint

__all__ = [
    "AuditRecord",
    "ComplianceLog",
    "ComplianceFramework",
    "DeploymentManager",
    "DeploymentSpec",
    "GlobalDeploymentManager",
    "ProcessingRecord",
    "RegionConfig",
    "REGIONS",
    "REGION_RULES",
    "STANDARDS",
    "STANDARD_POLICY",
    "production_readiness",
    "serving_health",
    "validate_region_config",
    "HealthState",
    "ServingEndpoint",
]
