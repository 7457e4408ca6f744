"""Mean milliseconds of the program's ``store.scan`` span a call: the
query upload, the scan's launch and the copy of its top-k to the
host, which waits for the device (``TorchVectorStore._flat_topk``),
over the profiled slice (``spans.py``)."""

from benchmark_h100.spans import mean_ms


def read(t: dict):
    return mean_ms(t, "store.scan")
