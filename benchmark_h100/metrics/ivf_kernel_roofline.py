"""``ivf_kernel`` (``ivf_scan_kernel``, then ``merge_small_k``) against
its least time (``yardstick.ivf_bound`` of the fills and buckets each
launch probed), over the profiled slice (``devtrace.roofline``)."""

from benchmark_h100.devtrace import roofline


def read(t: dict):
    return roofline(t, "ivf_kernel", ("ivf_scan_kernel", "merge_small_k"),
                    "ivf_scan_kernel")
