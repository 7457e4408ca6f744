"""Queries the coalescer folded into one ``batch_query`` flush over the
window: its own counters (``QueryCoalescer.get_stats``), queries served
(in shared batches, plus flushes of one) over flushes."""


def read(t: dict):
    c = t.get("coalescer")
    if not c or not c["batches"]:
        return None
    return c["queries"] / c["batches"]
