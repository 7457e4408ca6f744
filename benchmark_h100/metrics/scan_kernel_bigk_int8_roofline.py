"""``scan_kernel_bigk`` over int8 rows (the scan of the reranking
capacity cell, k = 4 x 10 candidates) against its least time, over the
profiled slice (``devtrace.roofline``; the least time is
``yardstick.bound`` for int8 rows: the rows' bytes read once).

A launch cuts the rows into chunks of the key scratch: each chunk is
scored (``scan_small_k``, or ``scan_small_k_tile``) and selected
(``sel_hist`` / ``sel_output`` / ``sel_sort``) on its own, and one
``merge_topk_kernel`` combines the chunks' lists. So where the slice
holds that merge it marks one launch each, and a scoring event one
chunk; without it (one chunk a launch) the scoring event is the
launch's."""

from benchmark_h100.devtrace import roofline

NAMES = ("scan_small_k", "sel_hist", "sel_output", "sel_sort",
         "merge_topk_kernel")


def read(t: dict):
    dev = t.get("device")
    merged = bool(dev) and any("merge_topk_kernel" in name
                               for name in dev["events_by_name"])
    return roofline(t, "scan_kernel_bigk", NAMES,
                    "merge_topk_kernel" if merged else "scan_small_k")
