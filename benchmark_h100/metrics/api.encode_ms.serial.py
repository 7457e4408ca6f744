"""Mean milliseconds of the program's ``api.encode`` span a request
with one request in flight: the reply's result dicts and JSON, over
the profiled slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "api.encode")
