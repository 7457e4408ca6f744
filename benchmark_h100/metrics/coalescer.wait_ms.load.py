"""Mean milliseconds of the program's ``coalescer.wait`` span a query
under load: from joining a lane to the start of the flush that takes
it (``service/batcher.py``), over the profiled slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "coalescer.wait")
