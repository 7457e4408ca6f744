"""Sharded IVF: a k-means quantizer a shard, a bucket probe a shard, one
k·P merge.

Counterpart of ``tpu_vector_db/parallel/sharded_ivf.py``: each shard of
a sharded store holds a LOCAL ``index/ivf.py::IVFIndex`` over its rows
(seed = the shard's global number), mirrored on its shard's device by
the index's own ``_ensure_device``; a query probes ``nprobe`` buckets on
every shard (``index/ivf.py::_select_and_probe``), and the shards' top-k
lists merge once on the lead device (``sharded_scan.merge_candidates``),
the sharded flat scan's pattern. On a mesh that spans processes each
process holds its own shards' indexes, and the merge ends in
``sharded_scan.merge_across_processes``: a W x L group trains and
answers as one process of P = W·L shards does.

* Bucket mode (f32/bf16 stores): each shard's probe is
  ``ops/ivf_scan.ivf_probe_topk``, the hand-written probe kernel on a
  CUDA tensor (its plain version on a CPU tensor), k <= 32. The JAX module
  probes with the XLA probe here.
* Gather mode (int8/int4 stores): no bucket copy; probes gather their
  rows from the store's shard (``ops/ivf_scan.ivf_gather_topk``: the
  gather probe kernel on a CUDA tensor, k <= 64; its plain version on a
  CPU tensor), as the port's ``IVFIndex`` does. int8 keys come back in
  the raw x127 scale.

Coverage: nprobe buckets PER SHARD, so P shards scan P times the buckets
of one index at the same nprobe; with nprobe >= every local bucket the
result equals the sharded flat scan.

The quantizers train on, and the bucket copies are gathered from, the
store's own shard tensors, so a full probe scores exactly the rows the
flat scan scores. The shards are probed one after another from Python,
so each keeps its own bucket count: the JAX module pads every shard to
one count for its stacked ``shard_map`` arrays, which has no counterpart
here. ``ann_sharded_ivf.npz`` has the JAX file's layout; a process of
a group writes its own shards only (keys by global shard number) and the
layout (W, r, L) beside them, and a file of another layout is rebuilt.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.index.ivf import (IVFIndex, _next_pow2,
                                           _select_and_probe, kernel_k_limit)
from tpu_vector_db_torch.ops.ivf_scan import MAX_IVF_KERNEL_K
from tpu_vector_db_torch.parallel.mesh import Mesh, local_count
from tpu_vector_db_torch.parallel.sharded_scan import _to, merge_shards
from tpu_vector_db_torch.utils.fs import atomic_save_npz

logger = logging.getLogger(__name__)

_QUANT = {torch.int8: "int8", torch.uint8: "int4"}


def _part(tensors: list | None, s: int):
    """Shard ``s``'s tensor of a per-shard list, or None."""
    return tensors[s] if tensors else None


class ShardedIVF:
    """P independent local IVF indexes over the contiguous row ranges of a
    sharded store, each mirrored on its shard's device."""

    SHARDED_IVF_FILE = "ann_sharded_ivf.npz"

    def __init__(self, dim: int, metric: str, mesh: Mesh,
                 nprobe: int = 32, n_clusters: int | None = None,
                 bucket_rows: int | None = None,
                 train_iters: int = 10) -> None:
        self.dim = dim
        self.metric = metric
        self.mesh = mesh
        self.n_dev = mesh.size      # this process's shards
        self.first = mesh.first_shard
        self.nprobe = int(nprobe)
        self.n_clusters = n_clusters
        self.bucket_rows = bucket_rows
        self.train_iters = int(train_iters)
        # 'int8'/'int4': gather mode, from the store's row dtype at build
        self.quant: str | None = None

        self._subs: list[IVFIndex] = []
        self._bc = 0
        self._rows_per_shard = 0
        self._count = 0
        self.build_time_s = 0.0

    # ------------------------------------------------------------- plumbing

    @property
    def built(self) -> bool:
        """Built over a live row: at least global shard 0's index is (on
        a mesh that spans processes, maybe on another process)."""
        return bool(self._subs) and self._count > 0

    @property
    def size(self) -> int:
        return self._count

    @property
    def n_buckets(self) -> int:
        """The most buckets any shard holds: an nprobe of at least this
        probes every bucket."""
        return max((len(sub._bucket_cluster) for sub in self._subs
                    if sub.built), default=1)

    def _set_quant(self, db: list) -> None:
        self.quant = _QUANT.get(db[0].dtype)
        if self.quant and self.metric == "euclidean":
            raise ValueError("quantized sharded IVF is cosine/dot only")

    def _sub(self, shard: int, n_clusters: int | None = None) -> IVFIndex:
        return IVFIndex(dim=self.dim, metric=self.metric,
                        n_clusters=n_clusters, nprobe=self.nprobe,
                        bucket_rows=self._bc,
                        train_iters=self.train_iters, seed=shard)

    def _mirror(self, db: list, sqnorms: list | None) -> None:
        """Bring every built shard's device mirror up to its rows."""
        for s, sub in enumerate(self._subs):
            if sub.built:
                sub._ensure_device(db[s], _part(sqnorms, s))

    # ----------------------------------------------------------------- build

    def build(self, db: list, count: int, sqnorms: list | None = None,
              scales: list | None = None) -> dict:
        """Train every shard's quantizer on its live rows of the store's
        shard tensors ``db`` (rows in the storage dtype; int4 with its
        ``scales``; euclidean ``sqnorms``) and mirror it on its device."""
        t0 = time.perf_counter()
        if len(db) != self.n_dev:
            raise ValueError(f"{len(db)} shards for a mesh of {self.n_dev}")
        self._set_quant(db)
        rows = db[0].shape[0]
        per_shard = max(min(count, rows), 1)
        c = self.n_clusters or IVFIndex.auto_clusters(per_shard)
        self._bc = self.bucket_rows or min(
            max(_next_pow2(int(per_shard / max(c, 1) * 1.3)), 256), 8192)
        self._subs = []
        for s in range(self.n_dev):
            local_n = local_count(count, rows, self.first + s)
            sub = self._sub(self.first + s, min(c, max(local_n, 1)))
            if local_n > 0:
                sub.build(db[s], local_n, scales=_part(scales, s))
            self._subs.append(sub)
        self._rows_per_shard = rows
        self._count = count
        self._mirror(db, sqnorms)
        self.build_time_s = time.perf_counter() - t0
        return {"nodes": count, "shards": self.n_dev, "clusters": c,
                "bucket_rows": self._bc, "build_time_s": self.build_time_s}

    # ------------------------------------------------------------------- add

    def add(self, db: list, old_count: int, new_count: int,
            sqnorms: list | None = None, scales: list | None = None) -> dict:
        """Extend each shard that rows [old_count, new_count) fall in with
        ``IVFIndex.add`` (nearest centroid, bucket slots, spills). A shard
        empty until now trains a quantizer sized to its own rows (the JAX
        module keeps the 1 cluster an empty shard was given at build); its
        number is listed in ``trained``."""
        t0 = time.perf_counter()
        if not self.built or old_count != self._count:
            raise ValueError(
                f"add must continue from {self._count}, got {old_count}")
        rows = self._rows_per_shard
        trained = []
        for g in range(old_count // rows, (new_count - 1) // rows + 1):
            s = g - self.first
            local_old = local_count(old_count, rows, g)
            local_n = local_count(new_count, rows, g)
            if local_n <= local_old or not 0 <= s < self.n_dev:
                continue
            sub = self._subs[s]
            if not sub.built:
                sub.n_clusters = self.n_clusters
                trained.append(g)
            sub.add(db[s], local_old, local_n, _part(sqnorms, s),
                    _part(scales, s))
        self._count = new_count
        self._mirror(db, sqnorms)
        dt = time.perf_counter() - t0
        self.build_time_s += dt
        return {"nodes": new_count - old_count, "build_time_s": dt,
                "trained": trained}

    # ---------------------------------------------------------------- search

    def search(self, queries, k: int, nprobe: int | None = None,
               db: list | None = None, scales: list | None = None):
        """(keys (Q, k), global ids (Q, k), -1 in empty slots) on the lead
        device, probing ``nprobe`` buckets on every shard.
        queries: PREPARED like the rows (cosine: unit, padded). Gather
        mode reads the store's shard tensors ``db`` (int4: and
        ``scales``). A bucketized probe on a CUDA device serves k <= 32."""
        if not self.built:
            raise RuntimeError("index not built")
        keys, ids, offsets = [], [], []
        for s, sub in enumerate(self._subs):
            if not sub.built:
                continue
            dev = sub._dev
            q = _to(queries, dev["ids"].device).float()
            gather = sub._layout == "gather"
            limit = kernel_k_limit(gather)
            if k > limit and q.device.type != "cpu":
                raise ValueError(
                    f"the IVF probe kernel supports k <= {limit} on a CUDA"
                    f" device, got k={k}; use the exact scan")
            layout = ("gather" if gather else
                      "kernel" if k <= MAX_IVF_KERNEL_K else "plain")
            p = min(nprobe or self.nprobe, len(sub._bucket_cluster))
            k_s, i_s = _select_and_probe(
                q, dev, db[s] if layout == "gather" else None,
                _part(scales, s), p, self.metric, k, layout)
            keys.append(k_s)
            ids.append(i_s)
            offsets.append((self.first + s) * self._rows_per_shard)
        if not keys:   # no built shard here: -inf keys join the merge
            lead = self.mesh.lead
            keys = [torch.full((queries.shape[0], k), float("-inf"),
                               device=lead)]
            ids = [torch.full((queries.shape[0], k), -1, dtype=torch.int32,
                              device=lead)]
            offsets = [0]
        return merge_shards(keys, ids, offsets, k, self.mesh)

    # ----------------------------------------------------------- persistence

    def save(self, directory) -> None:
        """One npz of every shard's host layout (the JAX file's keys); the
        device mirrors are gathered from it and the store's rows at
        load."""
        if not self.built:
            return
        payload = {"meta": np.array(
            [self.mesh.n_shards, self._rows_per_shard, self._count,
             self._bc, self.dim], np.int64)}
        if self.mesh.multiprocess:
            payload["layout"] = np.array(self.mesh.layout, np.int64)
        for s, sub in enumerate(self._subs, start=self.first):
            payload[f"built_{s}"] = np.array([int(sub.built)])
            if sub.built:
                payload[f"cents_{s}"] = sub._centroids
                payload[f"ids_{s}"] = sub._ids
                payload[f"bclust_{s}"] = sub._bucket_cluster
                payload[f"free_{s}"] = sub._free
                payload[f"n_{s}"] = np.array([sub._n])
        atomic_save_npz(Path(directory) / self.SHARDED_IVF_FILE, **payload)

    def load(self, directory, db: list, sqnorms: list | None = None) -> bool:
        """Open ``ann_sharded_ivf.npz`` when it was written for this many
        shards of this size, by a process of this layout; False (rebuild)
        otherwise."""
        path = Path(directory) / self.SHARDED_IVF_FILE
        if not path.exists():
            return False
        try:
            with np.load(path) as z:
                n_dev, rows, count, bc, dim = (int(v) for v in z["meta"])
                layout = (tuple(int(v) for v in z["layout"])
                          if "layout" in z.files else (1, 0, n_dev))
                if (n_dev != self.mesh.n_shards or dim != self.dim
                        or rows != db[0].shape[0]
                        or layout != self.mesh.layout):
                    logger.info("sharded IVF at %s was written for %d "
                                "shards of %d rows, layout %s; rebuilding",
                                path, n_dev, rows, layout)
                    return False
                self._bc = bc
                subs = []
                for s in range(self.first, self.first + self.n_dev):
                    sub = self._sub(s)
                    if int(z[f"built_{s}"][0]):
                        sub._centroids = z[f"cents_{s}"]
                        sub._ids = z[f"ids_{s}"]
                        sub._bucket_cluster = z[f"bclust_{s}"]
                        sub._free = z[f"free_{s}"]
                        sub._n = int(z[f"n_{s}"][0])
                    subs.append(sub)
            self._set_quant(db)
            self._subs = subs
            self._rows_per_shard = rows
            self._count = count
            self._mirror(db, sqnorms)
            return True
        except Exception:  # noqa: BLE001 — a corrupt index is rebuilt
            logger.exception("corrupt sharded IVF at %s; will rebuild",
                             path)
            return False

    def get_stats(self) -> dict:
        built = [s for s in self._subs if s.built]
        live = sum(int((s._ids >= 0).sum()) for s in built)
        slots = sum(s._ids.size for s in built)
        return {"type": "sharded_ivf", "nodes": self._count,
                "shards": self.mesh.n_shards, "nprobe": self.nprobe,
                "buckets_per_shard": self.n_buckets,
                "bucket_rows": self._bc,
                "fill_ratio": round(live / max(slots, 1), 3),
                "build_time_s": round(self.build_time_s, 3)}
