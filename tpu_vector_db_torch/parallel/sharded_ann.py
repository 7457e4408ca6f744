"""Sharded ANN: an independent beam-graph subgraph a shard, one k·P merge.

Counterpart of ``tpu_vector_db/parallel/sharded_ann.py``: each shard of a
sharded store owns a beam graph over its local rows, built on the host by
the native C++ builder (``index/native.py``: ``build_graph`` through
``BeamGraphIndex.build_cpu``, the shards' builds in parallel threads,
then ``extend_graph`` for appends, no rebuild). A query runs ``index/beam_graph.py::beam_search`` on every
shard's device over that shard's rows and graph alone (ids local, offset
afterwards; -1 stays -1), and the shards' top-k lists merge once on the
lead device (``sharded_scan.merge_candidates``). The union of the local
top-k lists holds the global top-k whenever each local search finds its
shard's winners, so recall matches one graph's on the same data.

On a mesh that spans processes each process builds, extends and searches
its own shards' subgraphs, and the merge ends in
``sharded_scan.merge_across_processes``.

``ann_sharded_graph.npz`` has the JAX file's layout; a process of a group
writes its own shards' rows only and the layout (W, r, L) beside them,
and a file of another layout is rebuilt.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.index.beam_graph import (DEFAULT_M, BeamGraphIndex,
                                                  beam_search)
from tpu_vector_db_torch.parallel.mesh import Mesh, local_count
from tpu_vector_db_torch.parallel.sharded_scan import _to, merge_shards
from tpu_vector_db_torch.utils.fs import atomic_save_npz

logger = logging.getLogger(__name__)


class ShardedBeamGraph:
    """P independent subgraphs over the contiguous row ranges of a sharded
    store: built and extended on the host, searched on the shards'
    devices."""

    SHARDED_GRAPH_FILE = "ann_sharded_graph.npz"

    def __init__(self, dim: int, metric: str, mesh: Mesh,
                 M: int = DEFAULT_M, ef_construction: int = 200,
                 alpha: float = 1.2) -> None:
        self.dim = dim
        self.metric = metric
        self.mesh = mesh
        self.n_dev = mesh.size      # this process's shards
        self.first = mesh.first_shard
        self.M = int(M)
        self.R = 2 * int(M)
        self.ef_construction = int(ef_construction)
        self.alpha = float(alpha)
        self._graph_dev: list[torch.Tensor] | None = None  # (rows, R) a shard
        self._entries_dev: list[torch.Tensor] = []          # (E,) a shard
        # this process's shards' rows (all of cap on one process): host
        # row s·rows + j is local row j of shard s, its ids local
        self._graphs_host: np.ndarray | None = None   # (L·rows, R) int32
        self._keys_host: np.ndarray | None = None     # (L·rows, R) f32
        self._entry_lists: list[np.ndarray] = []      # local row ids
        self._rows_per_shard = 0
        self._count = 0
        self.build_time_s = 0.0

    @property
    def built(self) -> bool:
        return self._graph_dev is not None

    @property
    def size(self) -> int:
        return self._count

    def _prepare(self, host_vectors: np.ndarray) -> np.ndarray:
        prepared = np.ascontiguousarray(host_vectors, np.float32)
        if self.metric == "cosine":
            norms = np.linalg.norm(prepared, axis=1, keepdims=True)
            prepared = prepared / np.maximum(norms, 1e-8)
        return prepared

    def _entry_target(self, local_n: int) -> int:
        """The entry count ``add`` gives a shard of ``local_n`` rows: 1024
        at most below 512K rows, 4096 from there."""
        cap = 1024 if local_n < (1 << 19) else 4096
        return int(min(cap, max(8, local_n // 64)))

    def _place(self) -> None:
        """The host graph and entry lists on the shards' devices."""
        rows = self._rows_per_shard
        self._graph_dev = None
        self._graph_dev = [
            torch.from_numpy(self._graphs_host[s * rows:(s + 1) * rows]).to(
                dev) for s, dev in enumerate(self.mesh.devices)]
        self._place_entries()

    def _place_entries(self) -> None:
        """Each shard's entries on its device, padded with -1 to a power
        of two (beam_search drops ids < 0)."""
        e_max = 1
        while e_max < max((len(e) for e in self._entry_lists), default=1):
            e_max *= 2
        entries = []
        for e, dev in zip(self._entry_lists, self.mesh.devices):
            padded = np.full((e_max,), -1, np.int32)
            padded[: len(e)] = e
            entries.append(torch.from_numpy(padded).to(dev))
        self._entries_dev = entries

    def build(self, host_vectors: np.ndarray, count: int,
              capacity: int) -> dict:
        """host_vectors: RAW (count, d) f32 rows of the store; capacity:
        the sharded store's capacity (a multiple of the shard count)."""
        t0 = time.perf_counter()
        if capacity % self.mesh.n_shards:
            raise ValueError(f"capacity {capacity} does not split over "
                             f"{self.mesh.n_shards} shards")
        rows = capacity // self.mesh.n_shards
        graphs = np.full((rows * self.n_dev, self.R), -1, np.int32)
        keys = np.full((rows * self.n_dev, self.R), -np.inf, np.float32)

        def build_shard(s: int) -> np.ndarray:
            """Shard s's subgraph into the host arrays; its entries."""
            lo, at = (self.first + s) * rows, s * rows
            local_n = local_count(count, rows, self.first + s)
            if local_n == 0:
                return np.empty((0,), np.int32)
            sub = BeamGraphIndex(dim=self.dim, metric=self.metric, M=self.M,
                                 ef_construction=self.ef_construction,
                                 alpha=self.alpha, device="cpu")
            sub.build_cpu(host_vectors[lo: lo + local_n], local_n)
            graphs[at: at + local_n] = sub._graph[:local_n]
            keys[at: at + local_n] = sub._edge_keys[:local_n]
            return sub._entries.copy()

        # the native builds release the interpreter lock: one thread a shard
        with ThreadPoolExecutor(max_workers=self.n_dev) as pool:
            entry_lists = list(pool.map(build_shard, range(self.n_dev)))
        # the host state stays, so that appends extend the subgraphs
        self._graphs_host = graphs
        self._keys_host = keys
        self._entry_lists = entry_lists
        self._rows_per_shard = rows
        self._count = count
        self._place()
        self.build_time_s = time.perf_counter() - t0
        return {"nodes": count, "shards": self.n_dev,
                "build_time_s": self.build_time_s}

    def add(self, host_vectors: np.ndarray, old_count: int,
            new_count: int) -> dict:
        """Insert rows [old_count, new_count) into their shards' subgraphs
        with the native extender; the changed graph rows go to the
        devices."""
        t0 = time.perf_counter()
        if not self.built or old_count != self._count:
            raise ValueError(
                f"add must continue from {self._count}, got {old_count}")
        rows = self._rows_per_shard
        touched: list[np.ndarray] = []
        for shard in range(old_count // rows, (new_count - 1) // rows + 1):
            s = shard - self.first
            lo, at = shard * rows, s * rows
            local_old = local_count(old_count, rows, shard)
            local_n = local_count(new_count, rows, shard)
            if local_n <= local_old or not 0 <= s < self.n_dev:
                continue
            g, k, _ = native.extend_graph(
                self._prepare(host_vectors[lo: lo + local_n]), local_old,
                self._graphs_host[at: at + local_old],
                self._keys_host[at: at + local_old],
                self.metric, self.R, self.ef_construction, self.alpha,
                entry_count=self._entry_target(local_n))
            old_g = self._graphs_host[at: at + local_n].copy()
            self._graphs_host[at: at + local_n] = g
            self._keys_host[at: at + local_n] = k
            touched.append(np.nonzero((g != old_g).any(axis=1))[0] + at)
            # entries are LOCAL row ids
            tgt = min(self._entry_target(local_n), local_n)
            self._entry_lists[s] = np.unique(
                np.linspace(0, local_n - 1, tgt).astype(np.int32))
        self._count = new_count
        n_touched = int(sum(len(t) for t in touched))
        if n_touched:
            ids = np.concatenate(touched)
            for s, dev in enumerate(self.mesh.devices):
                mine = ids[(ids >= s * rows) & (ids < (s + 1) * rows)]
                if len(mine):
                    self._graph_dev[s][torch.from_numpy(mine - s * rows).to(
                        dev)] = torch.from_numpy(self._graphs_host[mine]).to(
                        dev)
            self._place_entries()
        dt = time.perf_counter() - t0
        self.build_time_s += dt
        return {"nodes": new_count - old_count, "build_time_s": dt,
                "touched_rows": n_touched}

    def search(self, queries, db: list, count: int, k: int,
               ef_search: int = 100, sqnorms: list | None = None):
        """(keys (Q, k), global ids (Q, k), -1 where unreachable) on the
        lead device: ``beam_search`` on every shard over the store's shard
        rows ``db`` (queries PREPARED like them), with the single graph's
        budget, ~2·ef expansions of a beam 8 wide."""
        if not self.built:
            raise RuntimeError("index not built")
        ef = max(ef_search, k)
        iters = max(ef // 8 * 2, 8)
        rows = self._rows_per_shard
        keys, ids = [], []
        for s, graph in enumerate(self._graph_dev):
            i_s, k_s = beam_search(
                _to(queries, graph.device).float(), db[s], graph,
                self._entries_dev[s], local_count(count, rows, s), k=k,
                ef=ef, beam_width=8, iters=iters, metric=self.metric,
                sqnorms=sqnorms[s] if sqnorms else None)
            keys.append(k_s)
            ids.append(i_s)
        offsets = [(self.first + s) * rows for s in range(self.n_dev)]
        return merge_shards(keys, ids, offsets, k, self.mesh)

    # ----------------------------------------------------------- persistence

    def save(self, directory) -> None:
        if not self.built:
            return
        e_max = max((len(e) for e in self._entry_lists), default=1)
        entries = np.full((self.n_dev, e_max), -1, np.int32)
        for s, e in enumerate(self._entry_lists):
            entries[s, : len(e)] = e
        extra = ({"layout": np.array(self.mesh.layout, np.int64)}
                 if self.mesh.multiprocess else {})
        atomic_save_npz(
            Path(directory) / self.SHARDED_GRAPH_FILE,
            graphs=self._graphs_host, keys=self._keys_host, entries=entries,
            meta=np.array([self.mesh.n_shards, self._rows_per_shard,
                           self._count, self.M, self.ef_construction,
                           self.dim], np.int64), **extra)

    def load(self, directory, capacity: int) -> bool:
        """Open ``ann_sharded_graph.npz`` when it was written for this many
        shards of this size, by a process of this layout; False (rebuild)
        otherwise."""
        path = Path(directory) / self.SHARDED_GRAPH_FILE
        if not path.exists():
            return False
        try:
            with np.load(path) as z:
                n_dev, rows, count, m, _efc, dim = (int(v) for v in z["meta"])
                layout = (tuple(int(v) for v in z["layout"])
                          if "layout" in z.files else (1, 0, n_dev))
                if (n_dev != self.mesh.n_shards or dim != self.dim
                        or m != self.M or capacity // n_dev != rows
                        or z["graphs"].shape[0] != rows * self.n_dev
                        or layout != self.mesh.layout):
                    logger.info("sharded graph at %s was written for %d "
                                "shards of %d rows, layout %s; rebuilding",
                                path, n_dev, rows, layout)
                    return False
                self._graphs_host = z["graphs"]
                self._keys_host = z["keys"]
                entries = z["entries"]
            self._entry_lists = [e[e >= 0] for e in entries]
            self._rows_per_shard = rows
            self._count = count
            self._place()
            return True
        except Exception:  # noqa: BLE001 — a corrupt graph is rebuilt
            logger.exception("corrupt sharded graph at %s; will rebuild",
                             path)
            return False

    def get_stats(self) -> dict:
        return {"type": "sharded_beam_graph", "nodes": self._count,
                "shards": self.mesh.n_shards, "M": self.M, "R": self.R,
                "ef_construction": self.ef_construction,
                "build_time_s": round(self.build_time_s, 3)}
