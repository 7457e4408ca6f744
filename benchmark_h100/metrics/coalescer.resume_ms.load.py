"""Mean milliseconds of the program's ``coalescer.resume`` span a query
under load: from the flush setting its result to the handler running
again (the event loop's queue), over the profiled slice
(``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "coalescer.resume")
