"""ShardedVectorStore: a TorchVectorStore whose rows span a device mesh.

Counterpart of ``tpu_vector_db/parallel/sharded_store.py``: the same API,
metadata semantics and on-disk files as the single-device store; only
where the rows live changes. Capacity splits into P equal shards, shard
s holding rows ``[s·cap/P, (s+1)·cap/P)`` on its device (rows, euclidean
sqnorms, int4 scales); filter and tombstone masks split the same way.
The exact query is ``sharded_scan.sharded_flat_topk``: a scan a shard,
one k·P merge. This is BASELINE.md config #5's store (10M x 128).

* Appends write only into the shards whose range they touch, in the
  single-device store's upload blocks.
* ``index_type="auto"`` resolves to IVF: a store is sharded because the
  corpus outgrew one device, where IVF wins the routing. The index is a
  ``ShardedIVF`` (a quantizer a shard) or, for ``beam_graph``, a
  ``ShardedBeamGraph`` (a subgraph a shard) built by the native builder;
  without the builder the store serves the sharded flat scan. Appends
  extend either index; a capacity growth (new shard ranges) rebuilds it.
  The store runs no sampled-recall check, as the JAX sharded store runs
  none.
* A store written by either package, sharded or not, opens in the other
  and at another P (its sharded index sidecar is served at the P it was
  written for, and rebuilt at another).
* On a mesh that spans processes (multi-host serving) each process
  uploads only its own shards' rows: the rows of the other processes'
  shards stay in the host buffer. Every mutation reaches every process
  in lockstep, so the host state (rows, metadata, tombstones, count,
  capacity) is the same everywhere, and every process persists the whole
  store in the same files. A query's collectives are
  ``sharded_scan.merge_across_processes``'s.

The JAX package's ``_CompiledFnCache`` has no counterpart: nothing is
compiled per capacity or k here.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.ops.topk import to_host
from tpu_vector_db_torch.parallel.mesh import make_device_mesh
from tpu_vector_db_torch.parallel.sharded_scan import sharded_flat_topk
from tpu_vector_db_torch.store.config import (VectorStoreConfig, ann_param,
                                             index_args)
from tpu_vector_db_torch.store.vector_store import TorchVectorStore

logger = logging.getLogger(__name__)


class ShardedVectorStore(TorchVectorStore):
    def __init__(self, store_path, config: VectorStoreConfig | None = None,
                 mesh=None) -> None:
        self.mesh = mesh if mesh is not None else make_device_mesh()
        if len(self.mesh.shape) != 1:
            raise ValueError("a sharded store takes a 1-D mesh")
        # the global shard count: capacity splits over every process's
        self._n_dev = self.mesh.n_shards
        super().__init__(store_path, config, device=self.mesh.lead)

    @property
    def _rows_per_shard(self) -> int:
        return self._cap // self._n_dev

    # capacity splits evenly into per-shard block_rows multiples
    def _capacity_for(self, n: int) -> int:
        unit = self._block * self._n_dev
        cap = max(unit, self.config.initial_capacity)
        while cap < n:
            cap *= 2
        return ((cap + unit - 1) // unit) * unit

    def _local(self, shard: int) -> int | None:
        """This process's index of global shard ``shard``, or None."""
        s = shard - self.mesh.first_shard
        return s if 0 <= s < self.mesh.size else None

    def _check_device_budget(self, capacity: int) -> None:
        """Each device must hold its shards: cap/P rows a shard on it."""
        devices = self.mesh.devices
        for dev in set(devices):
            self.config.check_device_budget(
                capacity // self._n_dev * devices.count(dev), device=dev)

    def _reset_device(self, capacity: int) -> None:
        """(Re)build every shard's buffers from host state."""
        self._db = self._sqnorms = self._scales = None  # free before alloc
        self._cap = capacity
        rows = capacity // self._n_dev
        cols = self._d_pad // 2 if self._quant4 else self._d_pad
        devs = self.mesh.devices
        self._db = [torch.zeros((rows, cols), dtype=self._dtype, device=d)
                    for d in devs]
        if self.metric == "euclidean":
            self._sqnorms = [torch.zeros(rows, device=d) for d in devs]
        if self._quant4:
            self._scales = [torch.zeros(rows, device=d) for d in devs]
        if self._count:
            self._write_rows(self._host_buf[: self._count], 0)

    def _write_block(self, arr: np.ndarray, offset: int) -> None:
        """Prepare one upload block of host rows (``_write_rows`` splits
        the rows into blocks) and write it in place at ``offset``, each
        part uploaded once to the shard whose range it falls in (parts of
        another process's shards are not uploaded)."""
        rows = self._rows_per_shard
        stop = offset + arr.shape[0]
        for g in range(offset // rows, -(-stop // rows)):
            s = self._local(g)
            if s is None:
                continue
            lo, hi = max(offset, g * rows), min(stop, (g + 1) * rows)
            x = torch.from_numpy(np.ascontiguousarray(
                arr[lo - offset: hi - offset], np.float32)).to(
                self.mesh.devices[s])
            block, scales = self._prepare_block(x)
            a, b = lo - g * rows, hi - g * rows
            self._db[s][a:b] = block
            if self._scales is not None:
                self._scales[s][a:b] = scales
            if self._sqnorms is not None:
                self._sqnorms[s][a:b] = D.row_sqnorms(x)

    # ---------------------------------------------------------------- query

    def _filter_mask(self, host_mask: np.ndarray) -> list[torch.Tensor]:
        mask = torch.from_numpy(np.ascontiguousarray(host_mask, np.float32))
        rows, first = self._rows_per_shard, self.mesh.first_shard
        return [mask[(first + s) * rows:(first + s + 1) * rows].to(dev)
                for s, dev in enumerate(self.mesh.devices)]

    def _exact_topk(self, **scan_inputs):
        return sharded_flat_topk(**scan_inputs, mesh=self.mesh)

    # ------------------------------------------------------------------ ANN

    def _auto_pick_kind(self) -> str:
        """index_type='auto' is IVF on a sharded store at any row count,
        as _refresh_ann builds it, so the routing and get_stats describe
        the index that serves."""
        return "ivf"

    def _load_ann_sidecar(self, n: int) -> None:
        """The sharded indexes open their own sidecars in _refresh_ann; a
        single-device ann_ivf.npz or ann_graph.npz is not theirs."""
        self._refresh_ann()

    def _refresh_ann(self, incremental_from: int | None = None) -> None:
        """Per-shard IVF quantizers (auto, ivf) or per-shard subgraphs
        (beam_graph): appends extend them; a first build, or a capacity
        growth that moved the shard ranges, builds them (or opens the
        sidecar that covers the store)."""
        with self._ann_build_lock:
            if self._count == 0:
                return
            kind = ann_param(self.config.ann_params, "index_type")
            if kind in ("auto", "ivf"):
                self._refresh_sharded_ivf(incremental_from)
            elif kind == "flat":
                self._ann = None
                self._ann_stale = False
            elif not native.available():
                logger.warning("sharded ANN needs the native builder; "
                               "serving with the sharded flat scan")
                self._ann = None
            else:
                self._refresh_sharded_graph(incremental_from)

    def _extends(self, cls, incremental_from: int | None) -> bool:
        """Whether the index can extend from ``incremental_from``: one of
        ``cls``, at that size, over the current shard ranges."""
        return (isinstance(self._ann, cls) and bool(incremental_from)
                and self._ann.size == incremental_from
                and self._ann._rows_per_shard == self._rows_per_shard)

    def _persist_sharded_ann(self) -> None:
        if self.config.persist_mode != "off" and self._ann is not None:
            self._ann.save(self.store_path)

    def _refresh_sharded_graph(self, incremental_from: int | None) -> None:
        from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
        if self._extends(ShardedBeamGraph, incremental_from):
            self._ann.add(self._host_buf, incremental_from, self._count)
        else:
            self._ann = ShardedBeamGraph(
                dim=self.config.dimension, metric=self.metric,
                mesh=self.mesh, **index_args(self.config.ann_params, "M",
                                             "ef_construction", "alpha"))
            if (self._ann.load(self.store_path, self._cap)
                    and self._ann.size == self._count):
                self._ann_stale = False
                return
            self._ann.build(self._host_buf, self._count, self._cap)
        self._persist_sharded_ann()
        self._ann_stale = False

    def _refresh_sharded_ivf(self, incremental_from: int | None) -> None:
        from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
        if self._extends(ShardedIVF, incremental_from):
            self._ann.add(self._db, incremental_from, self._count,
                          self._sqnorms, self._scales)
        else:
            self._ann = ShardedIVF(
                dim=self.config.dimension, metric=self.metric,
                mesh=self.mesh, **index_args(
                    self.config.ann_params, "nprobe", "n_clusters",
                    "bucket_rows", "train_iters"))
            if (self._ann.load(self.store_path, self._db, self._sqnorms)
                    and self._ann.size == self._count):
                self._ann_stale = False
                return
            self._ann.build(self._db, self._count, self._sqnorms,
                            self._scales)
        self._persist_sharded_ann()
        self._ann_stale = False

    def _ann_search(self, queries_prepared, fetch_k: int):
        """The sharded index's (ids, keys) on the host, in the store's key
        convention: IVF probes ``nprobe`` buckets a shard (int8's x127
        scale divided out), the graph takes ef = max(ef_search,
        fetch_k)."""
        from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
        p = self.config.ann_params
        if isinstance(self._ann, ShardedIVF):
            keys, ids = self._ann.search(
                queries_prepared, fetch_k,
                nprobe=p.get("nprobe", self._ann.nprobe),
                db=self._db, scales=self._scales)
            keys, ids = to_host(keys, ids)
            if self.config.storage_dtype == "int8":
                keys = np.where(np.isfinite(keys), keys * (1.0 / 127.0),
                                keys)
            return ids, keys
        keys, ids = to_host(*self._ann.search(
            queries_prepared, self._db, self._count, fetch_k,
            ef_search=max(ann_param(p, "ef_search"), fetch_k),
            sqnorms=self._sqnorms))
        return ids, keys

    def get_stats(self) -> dict:
        stats = super().get_stats()
        stats["sharded"] = True
        stats["n_devices"] = self._n_dev
        stats["rows_per_shard"] = self._rows_per_shard
        return stats
