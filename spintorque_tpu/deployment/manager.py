"""Deployment manifests, serving health, and audit logging.

Counterpart of spin_torque_gym/deployment/global_deployment.py
(ComplianceFramework :64, GlobalDeploymentManager :246), reshaped for
accelerator hosts: a deployment is a set of host processes over GPU hosts, each
running the same SPMD program; this module generates launch specs,
validates environment readiness, exposes a serving health snapshot, and
keeps structured audit records.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class DeploymentSpec:
    """A multi-host accelerator deployment description."""

    name: str
    num_hosts: int = 1
    chips_per_host: int = 8
    coordinator_port: int = 8476
    batch_size: int = 4096
    mesh_model: int = 1
    env_vars: Dict[str, str] = field(default_factory=dict)
    regions: List[str] = field(default_factory=list)

    def launch_commands(self, coordinator_address: str) -> List[str]:
        """One command per host process (jax.distributed rendezvous)."""
        cmds = []
        for pid in range(self.num_hosts):
            env = {
                "JAX_COORDINATOR_ADDRESS": f"{coordinator_address}:{self.coordinator_port}",
                "JAX_NUM_PROCESSES": str(self.num_hosts),
                "JAX_PROCESS_ID": str(pid),
                "SPIN_TORQUE_BATCH_SIZE": str(self.batch_size),
                "SPIN_TORQUE_MESH_MODEL": str(self.mesh_model),
                **self.env_vars,
            }
            env_str = " ".join(f"{k}={v}" for k, v in sorted(env.items()))
            cmds.append(
                f"env {env_str} python -m spintorque_tpu.cli train"
            )
        return cmds

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


@dataclass
class AuditRecord:
    timestamp: float
    actor: str
    action: str
    detail: str
    region: Optional[str] = None


class ComplianceLog:
    """Append-only structured audit log (ComplianceFramework counterpart).

    Records deployment-relevant actions (model updates, config changes,
    data exports) with retention limits; exportable as JSONL for external
    compliance systems.
    """

    def __init__(self, path: Optional[str | Path] = None, retention: int = 10000):
        self.path = Path(path) if path else None
        self.retention = retention
        self.records: List[AuditRecord] = []

    def record(self, actor: str, action: str, detail: str = "",
               region: Optional[str] = None) -> AuditRecord:
        rec = AuditRecord(time.time(), actor, action, detail, region)
        self.records.append(rec)
        if len(self.records) > self.retention:
            self.records = self.records[-self.retention // 2 :]
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(asdict(rec)) + "\n")
        return rec

    def report(self) -> Dict[str, Any]:
        by_action: Dict[str, int] = {}
        for r in self.records:
            by_action[r.action] = by_action.get(r.action, 0) + 1
        return {"total": len(self.records), "by_action": by_action}


def serving_health() -> Dict[str, Any]:
    """Snapshot for a /healthz-style serving endpoint."""
    import jax

    from ..utils.monitoring import default_health_monitor

    checks = default_health_monitor().run()
    return {
        "status": checks["status"],
        "backend": jax.default_backend(),
        "devices": jax.device_count(),
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "time": time.time(),
        "checks": checks["checks"],
    }


class DeploymentManager:
    """Tracks deployments and readiness (GlobalDeploymentManager counterpart)."""

    def __init__(self, audit: Optional[ComplianceLog] = None):
        self.deployments: Dict[str, DeploymentSpec] = {}
        self.audit = audit or ComplianceLog()

    def register(self, spec: DeploymentSpec) -> None:
        self.deployments[spec.name] = spec
        self.audit.record("deployment-manager", "register", spec.name)

    def validate_environment(self, spec: DeploymentSpec) -> Dict[str, Any]:
        """Host-side readiness checks before launching a deployment."""
        import jax

        problems = []
        if spec.num_hosts < 1:
            problems.append("num_hosts must be >= 1")
        if spec.batch_size % max(1, spec.num_hosts * spec.chips_per_host):
            problems.append("batch_size not divisible by total chips")
        local = jax.local_device_count()
        report = {
            "ok": not problems,
            "problems": problems,
            "local_devices": local,
            "backend": jax.default_backend(),
        }
        self.audit.record("deployment-manager", "validate", json.dumps(report))
        return report

    def status(self) -> Dict[str, Any]:
        return {
            "deployments": {n: asdict(s) for n, s in self.deployments.items()},
            "audit": self.audit.report(),
        }
