"""Mean milliseconds of the program's ``coalescer.wait`` span a query
with one request in flight: from joining a lane to the start of its
flush (the coalescer's window), over the profiled slice
(``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "coalescer.wait")
