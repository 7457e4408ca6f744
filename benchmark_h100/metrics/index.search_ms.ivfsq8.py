"""Mean milliseconds of the program's ``index.search`` span a call (the
IVF's bucket selection, its gather-layout probe of the refine's
candidates and the copy of their keys to the host) over the profiled
slice, as the ``lib_rerank_ann`` generator reads it
(``Window.trace["index.search"]``). None where the program has no such
span or no call of the slice searched the index."""


def read(t: dict):
    span = t.get("index.search")
    if not span or not span["count"]:
        return None
    return 1e3 * span["total_s"] / span["count"]
