"""Mean milliseconds of the program's ``api.encode`` span a request
under load: the reply's result dicts and JSON
(``api/routes/vectors.py`` ``query_vectors``), over the profiled
slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "api.encode")
