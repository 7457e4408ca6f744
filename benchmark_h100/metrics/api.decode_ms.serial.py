"""Mean milliseconds of the program's ``api.decode`` span a request
with one request in flight: the body read, ``request.json()`` and
pydantic validation, over the profiled slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "api.decode")
