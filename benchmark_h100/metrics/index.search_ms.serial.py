"""Mean milliseconds of the program's ``index.search`` span a call with
one request in flight: the index's search (IVF bucket selection, the
probe, the copy to the host), over the profiled slice
(``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "index.search")
