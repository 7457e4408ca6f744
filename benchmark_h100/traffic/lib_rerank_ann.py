"""``lib_rerank``'s loop on a store whose index serves the refine's
candidates: one in-process caller, closed loop, back-to-back
``TorchVectorStore.batch_query(queries, k, rerank=True)`` of ``batch``
pool queries. On an IVF store over int8 rows with
``ivf_gather_large_k`` the gather-layout probe takes the ``k *
rerank_oversample`` candidates, which the store scores again in float32
against its host rows.

``lib_rerank.drive`` runs the window. In the traced run the window's
record (``Window.trace``) gains, beside ``store.rerank``:

* the program's spans ``index.search`` and ``index.probe`` over the
  profiled slice, each as {"count", "total_s", "rows"} (``rows``: the
  sum of the spans' ``rows`` attribute, the live rows the probes
  scored); a span the slice holds none of (a program without it, or a
  store that did not probe) is left out;
* ``ivf_gather_bounds_ms``: the least time (``yardstick.ivf_bound``) of
  each call of the program's gather probe
  (``index/ivf.py::ivf_gather_topk``) in the slice, from the fills,
  selection, k and rows it was given; left out where the program has no
  such function or the slice held no call.

A traffic file of this generator holds ``"generator":
"lib_rerank_ann"`` and exactly the keys of ``KEYS``.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_traffic_lib_rerank_ann_base",
    Path(__file__).with_name("lib_rerank.py"))
lib_rerank = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lib_rerank)

REST = lib_rerank.REST
KEYS = lib_rerank.KEYS
SPANS = ("index.search", "index.probe")
ROW_TYPES = {"torch.int8": "int8", "torch.uint8": "int4",
             "torch.bfloat16": "bfloat16", "torch.float32": "float32"}
warm_shapes = lib_rerank.warm_shapes


class ProbeSlice(lib_rerank.SpanSlice):
    """``lib_rerank``'s slice, with the spans ``SPANS`` that start in it
    read from the program's ring of finished spans, and the gather
    probe's calls recorded while it runs."""

    def start_slice(self) -> None:
        from tpu_vector_db_torch.index import ivf
        self._calls: list = []
        self._orig = getattr(ivf, "ivf_gather_topk", None)
        if self._orig is not None:
            orig, calls = self._orig, self._calls

            def ivf_gather_topk(queries, db_flat, bucket_ids, bucket_fills,
                                sel, k, *a, **kw):
                calls.append((bucket_fills, sel, int(k),
                              int(queries.shape[1]),
                              ROW_TYPES[str(db_flat.dtype)],
                              int(db_flat.shape[1]
                                  * db_flat.element_size())))
                return orig(queries, db_flat, bucket_ids, bucket_fills, sel,
                            k, *a, **kw)
            ivf.ivf_gather_topk = ivf_gather_topk
        super().start_slice()
        self._ns = time.perf_counter_ns()

    def stop_slice(self) -> None:
        ns_end = time.perf_counter_ns()
        super().stop_slice()
        from tpu_vector_db_torch.index import ivf
        from tpu_vector_db_torch.monitoring import tracing

        from benchmark_h100 import yardstick
        if self._orig is not None:
            ivf.ivf_gather_topk = self._orig
        if self._calls:
            self.record["ivf_gather_bounds_ms"] = [
                yardstick.ivf_bound(fills, sel, row_bytes, d, k, dtype)[0]
                for fills, sel, k, d, dtype, row_bytes in self._calls]
        self._calls = []
        for rec in tracing.spans():
            if rec["name"] in SPANS and \
                    self._ns <= rec["start_ns"] < ns_end:
                agg = self.record.setdefault(
                    rec["name"], {"count": 0, "total_s": 0.0, "rows": 0})
                agg["count"] += 1
                agg["total_s"] += (rec["end_ns"] - rec["start_ns"]) / 1e9
                agg["rows"] += int(rec["attrs"].get("rows", 0))


# the base generator's drive, with this slice in place of its own (this
# module's private copy of lib_rerank)
lib_rerank.SpanSlice = ProbeSlice


def drive(*, store, **kw):
    return lib_rerank.drive(store=store, **kw)
