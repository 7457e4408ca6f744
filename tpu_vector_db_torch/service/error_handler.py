"""Central error handler: classify, record, attempt recovery, degrade.

Capability parity with the reference's ``MLXErrorHandler``
(service/service_handling.py:410-600): error_context() contextmanager, ring
buffer of recent errors, category-specific recovery (gc on memory pressure,
disk probe on storage, give-up on corruption), degradation updates, graceful
SIGTERM/SIGINT shutdown that dumps error history, and a health_check()
score. The port of ``tpu_vector_db.service.error_handler``: memory
pressure empties torch's CUDA cache where the JAX handler clears its
compile caches. Plus the decorators (with_error_handling / with_circuit_breaker,
reference :604-630).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import logging
import os
import signal
import threading
from collections import deque
from pathlib import Path

import torch

from tpu_vector_db_torch.service.errors import (
    ErrorCategory, ErrorContext, ErrorSeverity, VectorDBError)
from tpu_vector_db_torch.service.resilience import (
    CircuitBreaker, GracefulDegradationManager, RetryHandler)

logger = logging.getLogger(__name__)

MAX_ERROR_HISTORY = 1000


class ErrorHandler:
    def __init__(self, error_log_dir: str | os.PathLike = "./logs") -> None:
        self._history: deque[ErrorContext] = deque(maxlen=MAX_ERROR_HISTORY)
        self._lock = threading.Lock()
        self._log_dir = Path(error_log_dir)
        self.degradation = GracefulDegradationManager()
        self.retry = RetryHandler()
        # per-operation breakers, parity with reference :419-424
        self.breakers = {
            name: CircuitBreaker(name)
            for name in ("vector_add", "vector_query", "storage_io",
                         "tpu_computation")
        }
        self._shutdown_installed = False

    def breaker(self, name: str) -> CircuitBreaker:
        """Get-or-create a named breaker. The serving path keys breakers
        PER TENANT (e.g. 'vector_query:user/model') — with one shared
        breaker, a single tenant's corrupt store opening the circuit
        would 503 every other tenant's queries for the full recovery
        window, renewably (review finding). One small object per active
        tenant; stats aggregate over all of them."""
        with self._lock:
            b = self.breakers.get(name)
            if b is None:
                b = self.breakers[name] = CircuitBreaker(name)
            return b

    # ------------------------------------------------------------ recording

    @contextlib.contextmanager
    def error_context(self, operation: str, user_id: str | None = None,
                      model_id: str | None = None, reraise: bool = True):
        """Classify + record + attempt recovery for anything raised inside."""
        try:
            yield
            self.degradation.record_request(failed=False)
        except Exception as exc:  # noqa: BLE001 — classification boundary
            ctx = ErrorContext.from_exception(exc, operation, user_id, model_id)
            ctx.recovery_attempted, ctx.recovery_succeeded = self._try_recover(ctx)
            with self._lock:
                self._history.append(ctx)
            self.degradation.record_request(failed=True)
            self.degradation.evaluate()
            logger.error("[%s/%s] %s failed: %s", ctx.category.value,
                         ctx.severity.value, operation, ctx.message)
            if reraise:
                if isinstance(exc, VectorDBError):
                    raise
                raise VectorDBError(str(exc), context=ctx) from exc

    def _try_recover(self, ctx: ErrorContext) -> tuple[bool, bool]:
        """Category-specific recovery (reference :486-540)."""
        if ctx.category == ErrorCategory.MEMORY:
            gc.collect()
            # return the caching allocator's free blocks to the card; a
            # server that never touched CUDA has nothing to release
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
            return True, True
        if ctx.category == ErrorCategory.STORAGE:
            try:
                usage = os.statvfs("/")
                free_frac = usage.f_bavail / max(usage.f_blocks, 1)
                return True, free_frac > 0.05
            except OSError:
                return True, False
        if ctx.severity == ErrorSeverity.CRITICAL:
            return False, False  # corruption: surface, don't mask
        return False, False

    # ---------------------------------------------------------------- stats

    def get_error_stats(self) -> dict:
        with self._lock:
            history = list(self._history)
        by_cat: dict[str, int] = {}
        for ctx in history:
            by_cat[ctx.category.value] = by_cat.get(ctx.category.value, 0) + 1
        return {
            "total_errors": len(history),
            "by_category": by_cat,
            "recovery_rate": (
                sum(1 for c in history if c.recovery_succeeded) /
                max(sum(1 for c in history if c.recovery_attempted), 1)),
            "degradation": self.degradation.get_stats(),
            "circuit_breakers": {n: b.get_stats()
                                 for n, b in self.breakers.items()},
        }

    def health_check(self) -> dict:
        """0-100 health score from breaker states, error rate, degradation."""
        stats = self.get_error_stats()
        score = 100.0
        for b in self.breakers.values():
            state = b.state.value
            if state == "open":
                score -= 25
            elif state == "half_open":
                score -= 10
        score -= stats["degradation"]["recent_errors_60s"] * 2
        level = self.degradation.level.value
        score -= level * 15
        score = max(score, 0.0)
        return {
            "score": round(score, 1),
            "status": ("healthy" if score >= 80 else
                       "degraded" if score >= 50 else "unhealthy"),
            **stats,
        }

    # ------------------------------------------------------------- shutdown

    def install_shutdown_handlers(self) -> None:
        """Dump error history on SIGTERM/SIGINT (reference :560-585)."""
        if self._shutdown_installed:
            return
        self._shutdown_installed = True
        previous = {}

        def handler(signum, frame):
            self.dump_history()
            prev = previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.default_int_handler(signum, frame)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    def dump_history(self) -> None:
        try:
            self._log_dir.mkdir(parents=True, exist_ok=True)
            with self._lock:
                payload = [c.to_dict() for c in self._history]
            (self._log_dir / "error_history.json").write_text(
                json.dumps(payload, indent=2))
        except OSError:
            logger.exception("failed to dump error history")


_global_handler: ErrorHandler | None = None
_global_lock = threading.Lock()


def get_error_handler() -> ErrorHandler:
    global _global_handler
    with _global_lock:
        if _global_handler is None:
            _global_handler = ErrorHandler()
        return _global_handler


def with_error_handling(operation: str, breaker: str | None = None):
    """Decorator: route a store/service method through the handler (and
    optionally a named circuit breaker)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            handler = get_error_handler()
            with handler.error_context(operation):
                if breaker and breaker in handler.breakers:
                    return handler.breakers[breaker].call(fn, *args, **kwargs)
                return fn(*args, **kwargs)
        return wrapper
    return deco
