"""Mean milliseconds of the program's ``manager.executor_wait`` span a
flush under load: from ``manager._dispatch`` handing the call to the
worker pool to a worker starting it, over the profiled slice
(``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "manager.executor_wait")
