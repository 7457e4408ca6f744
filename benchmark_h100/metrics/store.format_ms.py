"""Mean milliseconds of the program's ``store.format`` span a call: the
store's result formatting on the host (``_format_results`` over a
call, or the same loop after an index search), over the profiled
slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "store.format")
