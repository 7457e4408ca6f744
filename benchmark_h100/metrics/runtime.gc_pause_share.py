"""The share of the profiled slice the process spent in garbage
collection: the program's ``runtime.gc`` counter (every generation's
pause seconds while tracing is on) over the slice's seconds
(``spans.py``)."""

from benchmark_h100.spans import gc_pause_share


def read(t: dict):
    return gc_pause_share(t)
