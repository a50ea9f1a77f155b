"""Multi-host initialization and cross-host utilities.

The reference has no distributed backend at all (SURVEY.md section 5:
"Distributed communication backend: absent"). Here multi-host runs are
first-class: call ``initialize()`` once per host process before building a
mesh; JAX's distributed runtime handles rendezvous and the NVLink/network
fabric, and XLA inserts collectives from sharding annotations - no hand-written
NCCL/MPI analog is needed or wanted on the accelerator.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for a multi-host run.

    No-ops when running single-process (the common single-host case) so the
    same training script runs unchanged from 1 card to many hosts.
    Arguments default to the standard JAX env vars.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
        "backend": jax.default_backend(),
    }
