"""ctypes bridge to the native graph builder (native/graph_builder.cpp).

Counterpart of ``tpu_vector_db/index/native.py``, unchanged but for the
loader it imports (the port's own copy, ``pipeline/_native.py``, which
builds to the same ``native/libvdbgraph-<hash>.so``). Compiles the shared
library on first use, and reports unavailable when no compiler is
present; the store then builds the graph on its own device.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from tpu_vector_db_torch.pipeline._native import NativeLib

logger = logging.getLogger(__name__)


def _register(lib: ctypes.CDLL) -> None:
    lib.build_graph.restype = ctypes.c_int
    lib.build_graph.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.extend_graph.restype = ctypes.c_int
    lib.extend_graph.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]


# -funroll-loops + -fopenmp-simd vectorize the distance reductions (4-8x)
_NATIVE = NativeLib("graph_builder.cpp", "libvdbgraph.so", _register,
                    extra_flags=("-funroll-loops", "-fopenmp-simd"))


def load() -> ctypes.CDLL | None:
    return _NATIVE.load()


def available() -> bool:
    return load() is not None


def build_graph(vectors: np.ndarray, metric: str, R: int,
                ef_construction: int, alpha: float,
                entry_count: int = 8):
    """vectors: PREPARED (n, d) float32 (cosine rows normalized).
    Returns (graph (n,R) int32, edge_keys (n,R) f32, entries int32)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native graph builder not available")
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    graph = np.empty((n, R), np.int32)
    keys = np.empty((n, R), np.float32)
    entries = np.empty((entry_count,), np.int32)
    rc = lib.build_graph(
        vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(d),
        ctypes.c_int(1 if metric == "euclidean" else 0),
        ctypes.c_int(R), ctypes.c_int(ef_construction),
        ctypes.c_float(alpha),
        graph.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        entries.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(entry_count))
    if rc != 0:
        raise RuntimeError(f"native build_graph failed (rc={rc})")
    return graph, keys, np.unique(entries)


def extend_graph(vectors: np.ndarray, n_old: int, in_graph: np.ndarray,
                 in_keys: np.ndarray, metric: str, R: int,
                 ef_construction: int, alpha: float,
                 entry_count: int = 8):
    """Insert rows [n_old, len(vectors)) into an existing graph — O(batch)
    appends for per-shard subgraphs (no rebuild). vectors: PREPARED (n, d)
    float32 covering ALL rows; in_graph/in_keys: (n_old, R).
    Returns (graph (n,R) int32, edge_keys (n,R) f32, entries int32)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native graph builder not available")
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    in_graph = np.ascontiguousarray(in_graph[:n_old], np.int32)
    in_keys = np.ascontiguousarray(in_keys[:n_old], np.float32)
    if n_old and in_graph.shape[1] != R:
        raise ValueError(f"existing graph degree {in_graph.shape[1]} != {R}")
    graph = np.empty((n, R), np.int32)
    keys = np.empty((n, R), np.float32)
    entries = np.empty((entry_count,), np.int32)
    rc = lib.extend_graph(
        vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(n_old), ctypes.c_int64(d),
        ctypes.c_int(1 if metric == "euclidean" else 0),
        ctypes.c_int(R), ctypes.c_int(ef_construction),
        ctypes.c_float(alpha),
        in_graph.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        in_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        graph.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        entries.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(entry_count))
    if rc != 0:
        raise RuntimeError(f"native extend_graph failed (rc={rc})")
    return graph, keys, np.unique(entries)
