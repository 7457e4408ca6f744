"""Share of the query bodies the server decoded on its compiled path
(``api/query_body.py``) rather than the generic ``json`` + pydantic one:
the registry's ``query_bodies_native_total`` over it plus
``query_bodies_generic_total`` (``monitoring/metrics.py``), read in the
run's own process, where the server runs, over the whole run (warm-up
requests included). None for a program without the counters."""


def read(t: dict):
    try:
        from tpu_vector_db_torch.monitoring import get_registry
        reg = get_registry()
        native = reg.counter("query_bodies_native_total").value
        generic = reg.counter("query_bodies_generic_total").value
    except (ImportError, KeyError):
        return None
    total = native + generic
    return native / total if total else None
