"""Metrics + health (counterpart of reference monitoring/metrics.py — which
was complete but never imported by the app; here it is wired into the API),
and the tracer of the query path (``tracing``: spans and counters, on
while a torch profiler runs)."""

from tpu_vector_db_torch.monitoring.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    record_request,
    record_vector_query,
    record_vector_addition,
    record_query_body,
    record_cache_hit,
    record_index_build,
    record_error,
)
from tpu_vector_db_torch.monitoring.health import HealthChecker  # noqa: F401
