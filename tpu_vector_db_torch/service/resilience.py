"""Resilience primitives: circuit breaker, retry with backoff, degradation.

Capability parity with the reference's hardening layer
(service/service_handling.py:120-406): CircuitBreaker with
CLOSED/OPEN/HALF_OPEN (failure_threshold=5, recovery_timeout=30s,
success_threshold=3), RetryHandler with exponential backoff + jitter and
per-domain configs, GracefulDegradationManager with feature gating by
memory/error pressure. Differences by design: the breaker executes callees
inline with a deadline check instead of shipping every call through a
1-worker thread pool (the reference's approach serializes the hot path), and
degradation levels gate device-relevant features (ANN, bf16 demotion, batching).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from enum import Enum

logger = logging.getLogger(__name__)


# --------------------------------------------------------------- circuit

class CircuitState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreakerOpenError(RuntimeError):
    pass


@dataclass
class CircuitBreakerConfig:
    failure_threshold: int = 5
    recovery_timeout_s: float = 30.0
    success_threshold: int = 3
    # Client-input errors must NOT trip the breaker: 5 malformed requests
    # (dim mismatch -> ValueError) would otherwise open the shared breaker
    # and 503 every tenant for 30s — a one-key availability DoS. These
    # re-raise without touching the failure count.
    excluded: tuple = (ValueError, TypeError, KeyError)


class CircuitBreaker:
    """Per-operation breaker; thread-safe; call() wraps the callee."""

    def __init__(self, name: str,
                 config: CircuitBreakerConfig | None = None) -> None:
        self.name = name
        self.config = config or CircuitBreakerConfig()
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._failures = 0
        self._successes = 0
        self._opened_at = 0.0

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == CircuitState.OPEN and
                time.time() - self._opened_at >= self.config.recovery_timeout_s):
            self._state = CircuitState.HALF_OPEN
            self._successes = 0

    def call(self, fn, *args, **kwargs):
        with self._lock:
            self._maybe_half_open()
            if self._state == CircuitState.OPEN:
                raise CircuitBreakerOpenError(
                    f"circuit '{self.name}' is open "
                    f"(retry in {self.config.recovery_timeout_s - (time.time() - self._opened_at):.0f}s)")
        try:
            result = fn(*args, **kwargs)
        except Exception as exc:
            from tpu_vector_db_torch.service.errors import ValidationError
            if isinstance(exc, self.config.excluded) or \
                    isinstance(exc, ValidationError):
                # client error: neither a failure (won't open the circuit)
                # nor a success (won't close a HALF_OPEN one)
                raise
            self._record_failure()
            raise
        self._record_success()
        return result

    def _record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == CircuitState.HALF_OPEN or \
                    self._failures >= self.config.failure_threshold:
                if self._state != CircuitState.OPEN:
                    logger.warning("circuit '%s' OPEN after %d failures",
                                   self.name, self._failures)
                self._state = CircuitState.OPEN
                self._opened_at = time.time()
                self._successes = 0

    def _record_success(self) -> None:
        with self._lock:
            if self._state == CircuitState.HALF_OPEN:
                self._successes += 1
                if self._successes >= self.config.success_threshold:
                    self._state = CircuitState.CLOSED
                    self._failures = 0
                    logger.info("circuit '%s' CLOSED", self.name)
            elif self._state == CircuitState.CLOSED:
                self._failures = 0

    def get_stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": self._state.value,
                    "failures": self._failures}


# ----------------------------------------------------------------- retry

@dataclass
class RetryConfig:
    max_attempts: int = 3
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 10.0
    jitter: float = 0.25
    retryable: tuple = (OSError, TimeoutError, ConnectionError)


# per-domain defaults, parity with reference :426-430
DEFAULT_RETRY_CONFIGS = {
    "storage": RetryConfig(max_attempts=3),
    "computation": RetryConfig(max_attempts=2),
    "network": RetryConfig(max_attempts=5),
}


class RetryHandler:
    def __init__(self, configs: dict[str, RetryConfig] | None = None) -> None:
        self.configs = dict(DEFAULT_RETRY_CONFIGS)
        if configs:
            self.configs.update(configs)

    def run(self, domain: str, fn, *args, **kwargs):
        cfg = self.configs.get(domain, RetryConfig())
        delay = cfg.base_delay_s
        last_exc: Exception | None = None
        for attempt in range(cfg.max_attempts):
            try:
                return fn(*args, **kwargs)
            except cfg.retryable as exc:
                last_exc = exc
                if attempt == cfg.max_attempts - 1:
                    break
                sleep = min(delay, cfg.max_delay_s)
                sleep *= 1.0 + random.uniform(-cfg.jitter, cfg.jitter)
                logger.warning("retry %s attempt %d/%d after %.2fs: %s",
                               domain, attempt + 1, cfg.max_attempts, sleep, exc)
                time.sleep(max(sleep, 0.0))
                delay *= cfg.multiplier
        raise last_exc  # type: ignore[misc]


# ----------------------------------------------------------- degradation

class DegradationLevel(Enum):
    NORMAL = 0
    REDUCED = 1
    ESSENTIAL = 2
    EMERGENCY = 3


# feature gates per level (parity with reference :319-406, device features)
_FEATURES_BY_LEVEL = {
    DegradationLevel.NORMAL: {"ann", "batching", "caching", "persistence_sync"},
    DegradationLevel.REDUCED: {"ann", "batching", "persistence_sync"},
    DegradationLevel.ESSENTIAL: {"batching"},
    DegradationLevel.EMERGENCY: set(),
}


class GracefulDegradationManager:
    """Raises/lowers a degradation level from memory pressure and error rate."""

    def __init__(self, memory_thresholds=(0.80, 0.90, 0.95),
                 error_rate_thresholds=(0.05, 0.15, 0.40)) -> None:
        self._mem = memory_thresholds
        self._err = error_rate_thresholds
        self._lock = threading.Lock()
        self._level = DegradationLevel.NORMAL
        self._errors: list[float] = []
        self._requests = 0
        # windowed request counting for the error RATE: dividing the 60s
        # error count by the lifetime total (the old code) understates the
        # rate forever after a healthy warmup — and if only failures were
        # recorded it pinned the rate at ~100% (review finding). Two
        # rotating 60s buckets approximate a sliding request window
        # without storing per-request timestamps.
        self._win_start = time.time()
        self._win_req = 0
        self._prev_req = 0
        self._last_eval = 0.0

    def record_request(self, failed: bool) -> None:
        now = time.time()
        with self._lock:
            self._requests += 1
            age = now - self._win_start
            if age >= 60.0:
                self._prev_req = self._win_req if age < 120.0 else 0
                self._win_start = now
                self._win_req = 0
            self._win_req += 1
            if failed:
                self._errors.append(now)
            cutoff = now - 60.0
            self._errors = [t for t in self._errors if t >= cutoff]

    def _recent_requests(self, now: float) -> float:
        """Sliding-window request estimate over the last 60s."""
        frac = min(max((now - self._win_start) / 60.0, 0.0), 1.0)
        return self._win_req + self._prev_req * (1.0 - frac)

    def maybe_evaluate(self, min_interval_s: float = 1.0) -> DegradationLevel:
        """evaluate() at most once per interval — cheap enough for the
        per-request serving path (evaluate reads psutil)."""
        now = time.time()
        with self._lock:
            if now - self._last_eval < min_interval_s:
                return self._level
            self._last_eval = now
        return self.evaluate()

    def _memory_fraction(self) -> float:
        try:
            import psutil
            return psutil.virtual_memory().percent / 100.0
        except Exception:  # noqa: BLE001
            return 0.0

    def evaluate(self) -> DegradationLevel:
        mem = self._memory_fraction()
        now = time.time()
        with self._lock:
            recent = self._recent_requests(now)
            err_rate = (len(self._errors) / recent) if recent >= 1 else 0.0
            level = DegradationLevel.NORMAL
            for i, (m, e) in enumerate(zip(self._mem, self._err), start=1):
                if mem >= m or err_rate >= e:
                    level = DegradationLevel(i)
            if level != self._level:
                logger.warning("degradation level %s -> %s (mem=%.0f%%, err=%.1f%%)",
                               self._level.name, level.name, mem * 100,
                               err_rate * 100)
                self._level = level
            return self._level

    @property
    def level(self) -> DegradationLevel:
        with self._lock:
            return self._level

    def feature_enabled(self, feature: str) -> bool:
        return feature in _FEATURES_BY_LEVEL[self.level]

    def get_stats(self) -> dict:
        with self._lock:
            return {"level": self._level.name,
                    "recent_errors_60s": len(self._errors),
                    "requests": self._requests,
                    "features": sorted(_FEATURES_BY_LEVEL[self._level])}
