"""``lib_closed``'s loop with ``rerank=True`` on every call: one
in-process caller, closed loop, back-to-back
``TorchVectorStore.batch_query(queries, k, rerank=True)`` of ``batch``
pool queries, warm calls included. On a store of a lossy row type the
scan takes ``k * rerank_oversample`` candidates and the store scores
them again in float32 against its host rows; the answers judged are the
refined ones.

``lib_closed.drive`` runs the window, handed a store whose
``batch_query`` binds ``rerank=True``. In the traced run the window's
record (``Window.trace``) gains ``store.rerank``: the program's span of
that name over the profiled slice, as {"count", "total_s"} (left out
where the program has no such span). The harness profiles the slice on
the card only; on the CPU this generator profiles the slice's host
activity itself, so that the program's tracer, which records only while
a profiler runs, is on there too.

A traffic file of this generator holds ``"generator": "lib_rerank"``
and exactly the keys of ``KEYS``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_traffic_lib_closed", Path(__file__).with_name("lib_closed.py"))
lib_closed = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lib_closed)

REST = lib_closed.REST
KEYS = lib_closed.KEYS
SPAN = "store.rerank"
warm_shapes = lib_closed.warm_shapes


class Reranking:
    """The store as the loop sees it: every ``batch_query`` reranks."""

    def __init__(self, store) -> None:
        self.store = store

    def batch_query(self, queries, k: int):
        return self.store.batch_query(queries, k=k, rerank=True)


def _span_total(name: str):
    """(count, total seconds) of the program's span ``name`` so far, or
    None where the program has no such span."""
    from tpu_vector_db_torch.monitoring import tracing
    agg = tracing.summary()["spans"].get(name)
    return None if agg is None else (agg["count"], agg["total_s"])


class SpanSlice:
    """The harness's tracer, with the span ``SPAN`` read over its
    profiled slice (and, on the CPU, a host profile over the slice)."""

    def __init__(self, tracer) -> None:
        self.tracer = tracer
        self.record: dict = {}
        self._prof = None

    def start_slice(self) -> None:
        self.tracer.start_slice()
        if not self.tracer.cuda:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU])
            self._prof.__enter__()
        self._before = _span_total(SPAN)

    def stop_slice(self) -> None:
        after = _span_total(SPAN)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None
        self.tracer.stop_slice()
        if after is not None:
            n0, s0 = self._before or (0, 0.0)
            self.record[SPAN] = {"count": after[0] - n0,
                                 "total_s": after[1] - s0}


def drive(*, store, tracer, **kw):
    sliced = SpanSlice(tracer) if tracer is not None else None
    win = lib_closed.drive(store=Reranking(store), tracer=sliced, **kw)
    if sliced is not None:
        win.trace.update(sliced.record)
    return win
