"""Error taxonomy.

Capability parity with the reference's error model
(service/service_handling.py:48-115): severity/category enums, a rich context
record, and a typed exception hierarchy that the handler and API layer map to
structured responses. The port of ``tpu_vector_db.service.errors``; it
also files torch's CUDA out-of-memory error under MEMORY.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from enum import Enum

import torch


class ErrorSeverity(Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


class ErrorCategory(Enum):
    MEMORY = "memory"
    STORAGE = "storage"
    COMPUTATION = "computation"
    VALIDATION = "validation"
    NETWORK = "network"
    TIMEOUT = "timeout"
    UNKNOWN = "unknown"


@dataclass
class ErrorContext:
    operation: str
    category: ErrorCategory = ErrorCategory.UNKNOWN
    severity: ErrorSeverity = ErrorSeverity.MEDIUM
    timestamp: float = field(default_factory=time.time)
    user_id: str | None = None
    model_id: str | None = None
    message: str = ""
    stack_trace: str = ""
    memory_usage_mb: float | None = None
    recovery_attempted: bool = False
    recovery_succeeded: bool = False

    @classmethod
    def from_exception(cls, exc: Exception, operation: str,
                       user_id: str | None = None,
                       model_id: str | None = None) -> "ErrorContext":
        category, severity = classify_exception(exc)
        mem = None
        try:
            import psutil
            mem = psutil.Process().memory_info().rss / 2**20
        except Exception:  # noqa: BLE001 — psutil optional
            pass
        return cls(operation=operation, category=category, severity=severity,
                   user_id=user_id, model_id=model_id, message=str(exc),
                   stack_trace=traceback.format_exc(), memory_usage_mb=mem)

    def to_dict(self) -> dict:
        return {
            "operation": self.operation,
            "category": self.category.value,
            "severity": self.severity.value,
            "timestamp": self.timestamp,
            "user_id": self.user_id,
            "model_id": self.model_id,
            "message": self.message,
            "memory_usage_mb": self.memory_usage_mb,
            "recovery_attempted": self.recovery_attempted,
            "recovery_succeeded": self.recovery_succeeded,
        }


class VectorDBError(Exception):
    """Base framework error; carries the classified context."""

    category = ErrorCategory.UNKNOWN
    severity = ErrorSeverity.MEDIUM

    def __init__(self, message: str, context: ErrorContext | None = None):
        super().__init__(message)
        self.context = context


class MemoryPressureError(VectorDBError):
    category = ErrorCategory.MEMORY
    severity = ErrorSeverity.HIGH


class StorageCorruptionError(VectorDBError):
    category = ErrorCategory.STORAGE
    severity = ErrorSeverity.CRITICAL


class ComputationError(VectorDBError):
    category = ErrorCategory.COMPUTATION
    severity = ErrorSeverity.MEDIUM


class ValidationError(VectorDBError):
    category = ErrorCategory.VALIDATION
    severity = ErrorSeverity.LOW


class PeerLostError(VectorDBError):
    """Multi-host serving: a cross-process collective failed or did not
    complete within the watchdog window. The peer process is presumed
    dead, and this node can no longer answer from the whole store (every
    sharded query needs every process). The API maps this to a clean 503;
    recovery is a restart of the serving group (a gloo group cannot
    re-admit a process)."""

    category = ErrorCategory.NETWORK
    severity = ErrorSeverity.CRITICAL


def classify_exception(exc: Exception) -> tuple[ErrorCategory, ErrorSeverity]:
    if isinstance(exc, VectorDBError):
        return exc.category, exc.severity
    # torch.OutOfMemoryError ("CUDA out of memory") is a RuntimeError
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return ErrorCategory.MEMORY, ErrorSeverity.HIGH
    # TimeoutError IS an OSError subclass (py3.3+): it must be tested
    # BEFORE the storage branch or timeouts classify as STORAGE/HIGH and
    # trigger the disk-space 'recovery' probe (review finding)
    if isinstance(exc, TimeoutError):
        return ErrorCategory.TIMEOUT, ErrorSeverity.MEDIUM
    if isinstance(exc, (OSError, IOError)):
        return ErrorCategory.STORAGE, ErrorSeverity.HIGH
    if isinstance(exc, (ValueError, TypeError)):
        return ErrorCategory.VALIDATION, ErrorSeverity.LOW
    text = str(exc).lower()
    if "resource_exhausted" in text or "out of memory" in text or "hbm" in text:
        return ErrorCategory.MEMORY, ErrorSeverity.HIGH
    return ErrorCategory.UNKNOWN, ErrorSeverity.MEDIUM
