"""Structured logging setup.

Counterpart of spin_torque_gym/utils/logging_config.py (:18-269):
JSON-structured formatter, per-subsystem loggers, and a context manager for
scoped metadata. Multi-host aware: log records carry the JAX process index.
"""

from __future__ import annotations

import contextlib
import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

_CONTEXT: Dict[str, Any] = {}


class StructuredFormatter(logging.Formatter):
    """One JSON object per line (logging_config.py:18-51)."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        try:
            import jax

            payload["process"] = jax.process_index()
        except Exception:  # noqa: BLE001 - logging must never fail
            pass
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        payload.update(_CONTEXT)
        extra = getattr(record, "metrics", None)
        if extra:
            payload["metrics"] = extra
        return json.dumps(payload, default=str)


def setup_logging(
    level: str = "INFO",
    structured: bool = False,
    log_file: Optional[str] = None,
) -> logging.Logger:
    """Configure the 'spintorque_tpu' logger tree (logging_config.py:178-269)."""
    logger = logging.getLogger("spintorque_tpu")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()

    handler = logging.StreamHandler(sys.stderr)
    if structured:
        handler.setFormatter(StructuredFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
    logger.addHandler(handler)

    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(StructuredFormatter())
        logger.addHandler(fh)
    return logger


def get_logger(subsystem: str = "") -> logging.Logger:
    name = f"spintorque_tpu.{subsystem}" if subsystem else "spintorque_tpu"
    return logging.getLogger(name)


@contextlib.contextmanager
def LoggingContext(**fields):
    """Scoped structured-log metadata (logging_config.py:271-323)."""
    saved = dict(_CONTEXT)
    _CONTEXT.update(fields)
    try:
        yield
    finally:
        _CONTEXT.clear()
        _CONTEXT.update(saved)


class PerformanceLogger:
    """Metric-oriented logger facade (logging_config.py:54-120)."""

    def __init__(self, subsystem: str = "perf"):
        self.logger = get_logger(subsystem)

    def log_metrics(self, message: str, **metrics) -> None:
        self.logger.info(message, extra={"metrics": metrics})
