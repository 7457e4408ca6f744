"""Mean milliseconds of the program's ``api.decode`` span a request
under load: the body read, ``request.json()`` and pydantic
validation (``api/routes/_helpers.py`` ``parse_model``), over the
profiled slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "api.decode")
