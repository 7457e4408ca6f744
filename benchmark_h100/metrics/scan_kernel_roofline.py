"""``scan_kernel`` (k <= 32: ``scan_small_k`` or ``scan_small_k_tile``,
then ``merge_small_k``) against its least time, over the profiled
slice (``devtrace.roofline``)."""

from benchmark_h100.devtrace import roofline


def read(t: dict):
    return roofline(t, "scan_kernel", ("scan_small_k", "merge_small_k"),
                    "scan_small_k")
