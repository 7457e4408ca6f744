"""Metrics registry with Prometheus text exposition.

Capability parity with reference monitoring/metrics.py:30-295 (Counter /
Gauge values, a Histogram with a bounded series of recent observations
for its percentiles, pre-created HTTP / vector-op / cache / index / system
/ error metrics, a psutil sampler thread, Prometheus exposition,
module-level convenience recorders) — and unlike the reference, this
registry is actually attached to the serving app (SURVEY.md §2.1).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)
MAX_POINTS = 1000


@dataclass
class MetricPoint:
    timestamp: float
    value: float


class _Metric:
    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name: str, description: str = "") -> None:
        super().__init__(name, description)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.description}\n"
                f"# TYPE {self.name} counter\n"
                f"{self.name} {self.value}\n")


class Gauge(_Metric):
    def __init__(self, name: str, description: str = "") -> None:
        super().__init__(name, description)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.description}\n"
                f"# TYPE {self.name} gauge\n"
                f"{self.name} {self.value}\n")


class Histogram(_Metric):
    def __init__(self, name: str, description: str = "",
                 buckets: tuple = DEFAULT_BUCKETS) -> None:
        super().__init__(name, description)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        # the recent observations ``percentile`` reads
        self._points: deque[MetricPoint] = deque(maxlen=MAX_POINTS)

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            self._points.append(MetricPoint(time.time(), value))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            cumulative, acc = [], 0
            for c in self._counts:
                acc += c
                cumulative.append(acc)
            return {"sum": self._sum, "count": self._count,
                    "buckets": dict(zip([*map(str, self.buckets), "+Inf"],
                                        cumulative))}

    def recent(self, seconds: float = 60.0) -> list[MetricPoint]:
        cutoff = time.time() - seconds
        with self._lock:
            return [p for p in self._points if p.timestamp >= cutoff]

    def percentile(self, q: float, window_s: float = 300.0) -> float:
        pts = sorted(p.value for p in self.recent(window_s))
        if not pts:
            return 0.0
        idx = min(int(q * len(pts)), len(pts) - 1)
        return pts[idx]

    def expose(self) -> str:
        snap = self.snapshot()
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} histogram"]
        for le, count in snap["buckets"].items():
            lines.append(f'{self.name}_bucket{{le="{le}"}} {count}')
        lines.append(f"{self.name}_sum {snap['sum']}")
        lines.append(f"{self.name}_count {snap['count']}")
        return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Pre-creates the framework's metric families and samples system stats."""

    def __init__(self, sample_interval_s: float = 10.0) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._sampler: threading.Thread | None = None
        self._stop = threading.Event()
        self._interval = sample_interval_s

        # HTTP
        self.register(Counter("http_requests_total", "HTTP requests"))
        self.register(Counter("http_errors_total", "HTTP error responses"))
        self.register(Histogram("http_request_duration_seconds",
                                "request latency"))
        # vector ops
        self.register(Counter("vector_queries_total", "vector queries"))
        self.register(Counter("vector_additions_total", "vectors added"))
        self.register(Histogram("vector_query_duration_seconds",
                                "query latency"))
        self.register(Histogram("vector_add_duration_seconds", "add latency"))
        # cache / index
        self.register(Counter("cache_hits_total", "cache hits"))
        self.register(Counter("cache_misses_total", "cache misses"))
        self.register(Counter("index_builds_total", "ANN index builds"))
        self.register(Histogram("index_build_duration_seconds",
                                "index build time"))
        # system
        self.register(Gauge("system_cpu_percent", "host CPU %"))
        self.register(Gauge("system_memory_percent", "host memory %"))
        self.register(Gauge("system_disk_percent", "disk usage %"))
        self.register(Gauge("process_memory_mb", "process RSS MB"))
        # errors
        self.register(Counter("errors_total", "framework errors"))

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> _Metric:
        with self._lock:
            return self._metrics[name]

    def counter(self, name: str) -> Counter:
        return self.get(name)  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return self.get(name)  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return self.get(name)  # type: ignore[return-value]

    # ------------------------------------------------------------- sampler

    def start_sampler(self) -> None:
        if self._sampler is not None:
            return
        self._stop.clear()
        self._sampler = threading.Thread(
            target=self._sample_loop, name="metrics-sampler", daemon=True)
        self._sampler.start()

    def stop_sampler(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2)
            self._sampler = None

    def _sample_loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.sample_system()

    def sample_system(self) -> None:
        try:
            import psutil
            self.gauge("system_cpu_percent").set(psutil.cpu_percent())
            self.gauge("system_memory_percent").set(
                psutil.virtual_memory().percent)
            self.gauge("system_disk_percent").set(
                psutil.disk_usage("/").percent)
            self.gauge("process_memory_mb").set(
                psutil.Process().memory_info().rss / 2**20)
        except Exception:  # noqa: BLE001 — sampling must never break serving
            pass

    # ----------------------------------------------------------- exposition

    def get_prometheus_format(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.expose() for m in metrics)

    def summary(self) -> dict:
        q_hist = self.histogram("vector_query_duration_seconds")
        h_hist = self.histogram("http_request_duration_seconds")
        return {
            "http_requests": self.counter("http_requests_total").value,
            "http_errors": self.counter("http_errors_total").value,
            "vector_queries": self.counter("vector_queries_total").value,
            "vector_additions": self.counter("vector_additions_total").value,
            "query_p50_ms": round(q_hist.percentile(0.50) * 1e3, 3),
            "query_p99_ms": round(q_hist.percentile(0.99) * 1e3, 3),
            "http_p50_ms": round(h_hist.percentile(0.50) * 1e3, 3),
            "errors": self.counter("errors_total").value,
        }


_registry: MetricsRegistry | None = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


# convenience recorders (parity with reference :259-295)

def record_request(duration_s: float, error: bool = False) -> None:
    reg = get_registry()
    reg.counter("http_requests_total").inc()
    reg.histogram("http_request_duration_seconds").observe(duration_s)
    if error:
        reg.counter("http_errors_total").inc()


def record_vector_query(duration_s: float) -> None:
    reg = get_registry()
    reg.counter("vector_queries_total").inc()
    reg.histogram("vector_query_duration_seconds").observe(duration_s)


def record_vector_addition(count: int, duration_s: float) -> None:
    reg = get_registry()
    reg.counter("vector_additions_total").inc(count)
    reg.histogram("vector_add_duration_seconds").observe(duration_s)


def record_cache_hit(hit: bool) -> None:
    reg = get_registry()
    (reg.counter("cache_hits_total") if hit
     else reg.counter("cache_misses_total")).inc()


def record_index_build(duration_s: float) -> None:
    reg = get_registry()
    reg.counter("index_builds_total").inc()
    reg.histogram("index_build_duration_seconds").observe(duration_s)


def record_error() -> None:
    get_registry().counter("errors_total").inc()
