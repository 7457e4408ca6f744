"""Mean milliseconds of the program's ``store.rerank`` span a call (the
float32 re-scoring of a call's candidates against the host rows,
``TorchVectorStore._rerank_exact``) over the profiled slice, as the
``lib_rerank`` generator reads it (``Window.trace["store.rerank"]``).
None where the program has no such span or the slice held no call."""


def read(t: dict):
    span = t.get("store.rerank")
    if not span or not span["count"]:
        return None
    return 1e3 * span["total_s"] / span["count"]
