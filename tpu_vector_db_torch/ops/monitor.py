"""Thread-safe per-function performance counters.

Counterpart of ``tpu_vector_db/ops/monitor.py``: call count, total/avg
time, calls-per-sec, one process-wide instance. Kernels launch
asynchronously, so a timer that should cover device work synchronizes
the device first (``block=True``).
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field

import torch


@dataclass
class _FnStats:
    calls: int = 0
    total_time: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, dt: float) -> None:
        with self._lock:
            self.calls += 1
            self.total_time += dt

    def snapshot(self) -> dict:
        with self._lock:
            avg = self.total_time / self.calls if self.calls else 0.0
            cps = self.calls / self.total_time if self.total_time > 0 else 0.0
            return {
                "calls": self.calls,
                "total_time_s": self.total_time,
                "avg_time_ms": avg * 1000.0,
                "calls_per_sec": cps,
            }


def _synchronize(out) -> None:
    """Wait for the device that holds ``out`` (a tensor or a tuple/list
    of tensors), if it is a CUDA device."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for item in items:
        if isinstance(item, torch.Tensor) and item.is_cuda:
            torch.cuda.synchronize(item.device)
            return


class PerformanceMonitor:
    """Aggregates timings per function name; safe from any thread."""

    def __init__(self) -> None:
        self._stats: dict[str, _FnStats] = {}
        self._lock = threading.Lock()

    def _get(self, name: str) -> _FnStats:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = _FnStats()
            return self._stats[name]

    def record(self, name: str, dt: float) -> None:
        self._get(name).record(dt)

    def timed(self, name: str | None = None, block: bool = True):
        """Decorator: time a function, waiting for device results if
        asked."""
        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if block:
                    _synchronize(out)
                self.record(label, time.perf_counter() - t0)
                return out

            return wrapper
        return deco

    def get_stats(self) -> dict:
        with self._lock:
            names = list(self._stats)
        return {n: self._get(n).snapshot() for n in names}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


performance_monitor = PerformanceMonitor()
