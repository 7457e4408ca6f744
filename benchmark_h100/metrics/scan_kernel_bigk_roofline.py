"""``scan_kernel_bigk`` (k > 32: ``scan_small_k`` / ``scan_small_k_tile``
writing keys, the radix select ``sel_hist`` / ``sel_output`` /
``sel_sort``, and ``merge_topk_kernel`` over chunks) against its least
time, over the profiled slice (``devtrace.roofline``)."""

from benchmark_h100.devtrace import roofline


def read(t: dict):
    return roofline(t, "scan_kernel_bigk",
                    ("scan_small_k", "sel_hist", "sel_output", "sel_sort",
                     "merge_topk_kernel"), "scan_small_k")
