"""``ivf_gather_kernel`` (the gather layout's probe, then its merge:
``merge_topk_kernel`` past k = 32, ``merge_small_k`` up to it) against
its least time, over the profiled slice (``devtrace.roofline``). The
least time of a launch is ``yardstick.ivf_bound`` of the fills and
selection it probed (the live rows of the distinct probed buckets read
once), as the ``lib_rerank_ann`` generator records them
(``Window.trace["ivf_gather_bounds_ms"]``). In the cells that list this
metric no other kernel of those names runs. None where the program has
no such kernel or the slice held no launch of it."""

from benchmark_h100.devtrace import roofline


def read(t: dict):
    bounds = t.get("ivf_gather_bounds_ms")
    if not bounds:
        return None
    return roofline({**t, "bounds_ms": {"ivf_gather_kernel": bounds}},
                    "ivf_gather_kernel",
                    ("ivf_gather_kernel", "merge_topk_kernel",
                     "merge_small_k"), "ivf_gather_kernel")
