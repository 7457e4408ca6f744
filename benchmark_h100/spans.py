"""The program's own spans and counters over a traced run's profiled
slice, for the per-layer metrics that read them (``metrics/<name>.py``).

The port's tracer (``tpu_vector_db_torch.monitoring.tracing``) records
only while a torch profiler runs in the process, and its aggregates are
never reset, so they cover every profile of the run: the profiled slice
(``devtrace.Profiled``, whose record is ``t["device"]``), the short
profile of ``Profiled.warm`` at set-up, before any traffic, and the
profiler's own enable and disable calls at the slice's two ends, which
``window_s`` leaves out. A run with no slice, a program without the
tracer, or a span with no records reads None.
"""

from __future__ import annotations


def summary(t: dict) -> dict | None:
    if not t.get("device"):
        return None
    try:
        from tpu_vector_db_torch.monitoring import tracing
    except ImportError:
        return None
    return tracing.summary()


def mean_ms(t: dict, name: str) -> float | None:
    """Mean milliseconds of the span ``name``: its total over its count."""
    s = summary(t)
    agg = s["spans"].get(name) if s else None
    if not agg or not agg["count"]:
        return None
    return 1e3 * agg["total_s"] / agg["count"]


def gc_pause_share(t: dict) -> float | None:
    """Seconds of garbage-collection pauses (``runtime.gc``, every
    generation) over the slice's seconds (pauses during the profiler's
    enable and disable calls count too); None where no span was traced."""
    s = summary(t)
    if not s or not s["spans"] or t["device"]["window_s"] <= 0:
        return None
    return sum(s["counters"]["runtime.gc"]["pause_s"]) \
        / t["device"]["window_s"]
