"""Wall milliseconds a ``TorchVectorStore.batch_query`` call over the
window: a span the harness puts around the store's method in the traced
run."""


def read(t: dict):
    calls = t.get("store_calls_s")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
