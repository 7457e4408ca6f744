"""IVFIndex: inverted-file ANN over k-means buckets.

Counterpart of ``tpu_vector_db/index/ivf.py``, with the same host-side
layout, placement and ``ann_ivf.npz`` file, so an index written by either
package opens in the other:

* BUILD is k-means (``ops/kmeans.py``) over the store's device matrix,
  then a cluster-major bucket layout (NB, Bc) of row ids; clusters larger
  than Bc spill into more buckets, each of which competes for probe slots
  with its cluster's score.
* SEARCH picks ``nprobe`` buckets by centroid score (``_select_buckets``:
  a stable top-k, ties to the lower bucket index, as ``lax.top_k``), then
  probes them in one of three layouts:
  - ``"kernel"``: the bucketized f32/bf16 copy through the CUDA kernel
    ``ivf_kernel`` (``ops/ivf_scan.ivf_probe_topk``) for k <= 32; where the
    JAX index picks its Pallas kernel on a TPU, this one picks the kernel
    on a CUDA tensor (a CPU tensor takes the kernel's plain version). The
    port's kernel also scores euclidean keys, which the TPU kernel left to
    XLA;
  - ``"plain"``: the bucketized copy through ``ivf_probe_topk_plain``, for
    k > 32 on a CPU tensor only; on a CUDA tensor such a search raises
    ValueError (the store sends k > 32 to the exact big-k scan);
  - ``"gather"``: int8/int4 stores (and bf16 with ``layout="gather"``)
    keep no row copy; probes gather rows from the store's flat matrix,
    through the CUDA kernel ``ivf_gather_kernel``
    (``ops/ivf_scan.ivf_gather_topk``), k <= 64 on a CUDA tensor (its
    plain version, any k, on the CPU).
  Keys and ids come back in ONE device-to-host copy (``ops/topk.to_host``).
* ADD assigns new rows to the nearest existing centroid and fills bucket
  free slots, spilling into new buckets; the device copy is updated in
  place (``index_copy_``) unless the bucket count grew.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops import kmeans
from tpu_vector_db_torch.ops.ivf_scan import (MAX_GATHER_KERNEL_K,
                                              MAX_IVF_KERNEL_K,
                                              ivf_gather_topk,
                                              ivf_probe_topk,
                                              ivf_probe_topk_plain)
from tpu_vector_db_torch.ops.topk import NEG_INF, to_host, top_k
from tpu_vector_db_torch.utils.fs import atomic_save_npz

logger = logging.getLogger(__name__)

IVF_FILE = "ann_ivf.npz"


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _select_buckets(queries, centroids, bucket_cluster, nprobe: int,
                    metric: str, c_sqnorms):
    """(Q, nprobe) bucket ids by descending centroid key, ties to the lower
    bucket index. Dead buckets (cluster -1) never win."""
    cross = queries.float() @ centroids.T                       # (Q, C)
    cscore = 2.0 * cross - c_sqnorms[None, :] if metric == "euclidean" \
        else cross
    bscore = cscore[:, torch.clamp(bucket_cluster, min=0).long()]
    bscore = torch.where(bucket_cluster[None, :] >= 0, bscore,
                         torch.full_like(bscore, NEG_INF))
    return top_k(bscore, nprobe)[1]


def kernel_k_limit(gather: bool) -> int:
    """The largest k an IVF probe serves on a CUDA device: the gather
    layout's kernel keeps two list entries a lane (64), the bucketized
    one one (32)."""
    return MAX_GATHER_KERNEL_K if gather else MAX_IVF_KERNEL_K


def _probe_rows(sel, fills):
    """Reader of the live rows a probe of ``sel`` scores (the probed
    buckets' fills summed), for tracing. On the card the sum and its copy
    to the host are queued before the probe and only they are waited
    for, so reading it does not wait for the probe."""
    total = fills[sel.long()].sum()
    if total.device.type != "cuda":
        return lambda: int(total)
    host = torch.empty((), dtype=total.dtype, pin_memory=True)
    host.copy_(total, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(total.device))

    def read() -> int:
        done.synchronize()
        return int(host)
    return read


def _select_and_probe(q, dev: dict, db, scales, nprobe: int, metric: str,
                      k: int, layout: str):
    """Centroid selection + bucket probe: (keys (Q, k), ids (Q, k)).

    The probe is the span ``index.probe``, with ``slots`` (Q x nprobe x
    bucket rows) and ``rows``, the live rows it scored (the probed
    buckets' fills summed), worked out only while tracing is on and
    without waiting for the probe (``_probe_rows``): the span holds the
    probe's launches, not its device time."""
    sel = _select_buckets(q, dev["centroids"], dev["bucket_cluster"], nprobe,
                          metric, dev["c_sqnorms"])
    with tracing.span("index.probe"):
        rows = _probe_rows(sel, dev["fills"]) if tracing.on() else None
        if layout == "gather":
            out = ivf_gather_topk(q, db, dev["ids"], dev["fills"], sel, k,
                                  metric=metric, db_scales=scales)
        elif layout == "kernel":
            out = ivf_probe_topk(q, dev["buckets"], dev["ids"], dev["fills"],
                                 sel, k, metric=metric,
                                 bucket_sqnorms=dev.get("sqnorms"))
        else:
            out = ivf_probe_topk_plain(q, dev["buckets"], dev["ids"], sel, k,
                                       metric=metric,
                                       bucket_sqnorms=dev.get("sqnorms"))
        if rows is not None:
            tracing.annotate("slots", sel.numel() * dev["ids"].shape[1])
            tracing.annotate("rows", rows())
    return out


def _scatter_rows(buckets, flat_pos, rows):
    """Write ``rows`` into bucket slots ``flat_pos`` in place."""
    nb, bc, d = buckets.shape
    buckets.view(nb * bc, d).index_copy_(0, flat_pos, rows.to(buckets.dtype))
    return buckets


def _scatter_scalars(arr2d, flat_pos, vals):
    """Write ``vals`` into (NB, Bc) slots ``flat_pos`` in place."""
    nb, bc = arr2d.shape
    arr2d.view(nb * bc).index_copy_(0, flat_pos, vals.to(arr2d.dtype))
    return arr2d


class IVFIndex:
    """Owns the centroids and the bucket layout, and (bucketized layout) a
    copy of the rows in the storage dtype on the store's device, ~1x the
    store size. The gather layout (int8/int4 stores) holds only the
    (NB, Bc) id table and the centroids on the device."""

    def __init__(self, dim: int, metric: str = "cosine",
                 n_clusters: int | None = None, nprobe: int = 32,
                 bucket_rows: int | None = None, train_iters: int = 10,
                 seed: int = 0, layout: str = "auto") -> None:
        self.dim = dim
        self.metric = metric
        self.n_clusters = n_clusters          # None = auto at build
        self.nprobe = int(nprobe)
        self.bucket_rows = bucket_rows        # None = auto at build
        self.train_iters = int(train_iters)
        self._seed = seed
        # 'auto': gather for quantized dtypes, bucketized otherwise;
        # 'gather' / 'bucketized' force one (quantized stores gather)
        if layout not in ("auto", "gather", "bucketized"):
            raise ValueError(f"layout must be auto|gather|bucketized, "
                             f"got {layout!r}")
        self.layout_mode = layout

        self._n = 0
        self._centroids: np.ndarray | None = None       # (C, d_pad) f32 host
        self._ids: np.ndarray | None = None             # (NB, Bc) i32 host
        self._bucket_cluster: np.ndarray | None = None  # (NB,) i32 host
        self._free: np.ndarray | None = None            # (NB,) free slots
        self._open: np.ndarray | None = None  # (C,) cluster -> open bucket
        self.build_time_s = 0.0

        # device mirrors, materialized lazily from the store's db
        self._dev: dict | None = None
        self._dev_rows = 0
        self._layout = None       # 'bucketized' | 'gather'
        self._slot_bytes: int | None = None

    # ------------------------------------------------------------- plumbing

    @property
    def built(self) -> bool:
        return self._n > 0 and self._centroids is not None

    @property
    def size(self) -> int:
        return self._n

    @staticmethod
    def auto_clusters(count: int) -> int:
        """max(2*sqrt(N), N/1024), power of two: 1M -> 2048, 10M -> 16384."""
        c = max(2 * np.sqrt(max(count, 1)), count / 1024)
        return min(max(_next_pow2(int(c)), 16), 65536)

    def _auto_bucket_rows(self, count: int, n_clusters: int) -> int:
        avg = max(count // n_clusters, 1)
        return min(max(_next_pow2(int(avg * 1.3)), 256), 8192)

    # ----------------------------------------------------------------- build

    def build(self, db, count: int, sqnorms=None, scales=None) -> dict:
        t0 = time.perf_counter()
        c = self.n_clusters or self.auto_clusters(count)
        c = min(c, max(count, 1))
        bc = self.bucket_rows or self._auto_bucket_rows(count, c)
        self._dev = None     # free the old bucket copy before training
        centroids, _ = kmeans.train_kmeans(
            db, count, c, metric=self.metric, iters=self.train_iters,
            seed=self._seed, db_scales=scales)
        assign = kmeans.assign_clusters(
            db, count, centroids, metric=self.metric,
            db_scales=scales).cpu().numpy()[:count]
        self._centroids = centroids.cpu().numpy().astype(np.float32)
        self._bucketize(assign, count, bc)
        self._n = count
        self._dev_rows = 0
        self._layout = ("gather" if self._gather_layout(db)
                        else "bucketized")
        self.build_time_s = time.perf_counter() - t0
        logger.info(
            "IVF built: %d rows, %d clusters, %d buckets x %d rows in %.1fs",
            count, c, len(self._bucket_cluster), bc, self.build_time_s)
        return {"nodes": count, "build_time_s": self.build_time_s,
                "clusters": c, "buckets": len(self._bucket_cluster)}

    def _bucketize(self, assign: np.ndarray, count: int, bc: int) -> None:
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=len(self._centroids))
        ids_rows, clusters, free = [], [], []
        pos = 0
        for cl, sz in enumerate(sizes):
            rows = order[pos: pos + sz]
            pos += sz
            if sz == 0:
                continue
            for s in range(0, sz, bc):
                chunk = rows[s: s + bc]
                row = np.full(bc, -1, np.int32)
                row[: len(chunk)] = chunk
                ids_rows.append(row)
                clusters.append(cl)
                free.append(bc - len(chunk))
        self._ids = np.stack(ids_rows).astype(np.int32)
        self._bucket_cluster = np.asarray(clusters, np.int32)
        self._free = np.asarray(free, np.int64)
        self._open = None

    # ------------------------------------------------------------------- add

    def add(self, db, old_count: int, new_count: int, sqnorms=None,
            scales=None) -> dict:
        """Assign rows [old_count, new_count) to their nearest centroids
        and fill bucket free slots: no retrain, no rebuild."""
        t0 = time.perf_counter()
        if not self.built:
            return self.build(db, new_count, sqnorms, scales=scales)
        if old_count != self._n:
            raise ValueError(f"add must continue from {self._n}, "
                             f"got {old_count}")
        n_new = new_count - old_count
        new_rows = kmeans._widen_block(
            db[old_count:new_count],
            scales[old_count:new_count] if scales is not None else None
        ).float()
        cents = torch.from_numpy(self._centroids).to(db.device)
        cscore = new_rows @ cents.T
        if self.metric == "euclidean":
            cscore = 2.0 * cscore - torch.sum(cents * cents, -1)[None, :]
        assign = torch.argmax(cscore, dim=-1).cpu().numpy().astype(np.int32)

        placed = self._place_rows(assign, np.arange(old_count, new_count))
        self._n = new_count
        if self._dev is not None and placed:
            bc = self._ids.shape[1]
            triples = np.asarray(placed, np.int64)
            flat_pos = torch.from_numpy(
                triples[:, 0] * bc + triples[:, 1]).to(db.device)
            row_ids = torch.from_numpy(triples[:, 2]).to(db.device)
            if "buckets" in self._dev:   # bucketized layout only
                _scatter_rows(self._dev["buckets"], flat_pos, db[row_ids])
                if self._dev["sqnorms"] is not None and sqnorms is not None:
                    _scatter_scalars(self._dev["sqnorms"], flat_pos,
                                     sqnorms[row_ids])
            _scatter_scalars(self._dev["ids"], flat_pos, row_ids)
            self._dev["fills"] = torch.from_numpy(
                (self._ids.shape[1] - self._free).astype(np.int32)).to(
                db.device)
            self._dev_rows = new_count
        dt = time.perf_counter() - t0
        self.build_time_s += dt
        return {"nodes": n_new, "build_time_s": dt}

    def _open_map(self) -> np.ndarray:
        """(C,) cluster -> bucket with free space (-1 = none), rebuilt
        lazily from _free/_bucket_cluster."""
        if self._open is None or len(self._open) != len(self._centroids):
            self._open = np.full(len(self._centroids), -1, np.int64)
            cand = np.where(self._free > 0)[0]
            # ascending scatter: the LAST open bucket of a cluster wins
            self._open[self._bucket_cluster[cand]] = cand
        return self._open

    def _place_rows(self, assign: np.ndarray,
                    row_ids: np.ndarray) -> list[tuple[int, int, int]]:
        """Host-side bucket placement: fill each cluster's open bucket,
        spill into new buckets. Returns (bucket, slot, row_id) triples;
        drops the device mirror if buckets grew. All spill buckets of the
        call are allocated in one table growth."""
        bc = self._ids.shape[1]
        open_map = self._open_map()
        row_ids = np.asarray(row_ids, np.int64)
        order = np.argsort(assign, kind="stable")
        sorted_cl = np.asarray(assign, np.int64)[order]
        sorted_rows = row_ids[order]
        uniq, starts = np.unique(sorted_cl, return_index=True)
        counts = np.diff(np.append(starts, len(sorted_cl)))

        # batch-allocate every spill bucket this call will need
        open_b = open_map[uniq]
        free_open = np.where(open_b >= 0,
                             self._free[np.maximum(open_b, 0)], 0)
        n_new = np.ceil(np.maximum(counts - free_open, 0) / bc).astype(
            np.int64)
        total_new = int(n_new.sum())
        nb_cursor = len(self._bucket_cluster)
        if total_new:
            self._ids = np.vstack(
                [self._ids, np.full((total_new, bc), -1, np.int32)])
            self._bucket_cluster = np.concatenate(
                [self._bucket_cluster,
                 np.repeat(uniq, n_new).astype(np.int32)])
            self._free = np.concatenate(
                [self._free, np.full(total_new, bc, np.int64)])
            self._dev = None  # bucket count changed: re-materialize

        placed_b = np.empty(len(sorted_rows), np.int64)
        placed_s = np.empty(len(sorted_rows), np.int64)
        offs = np.arange(len(sorted_cl)) - np.repeat(starts, counts)

        # common case: the cluster's rows fit in its open bucket
        fits = (open_b >= 0) & (counts <= free_open)
        if fits.any():
            row_fits = np.repeat(fits, counts)
            b_rows = np.repeat(np.where(fits, open_b, 0), counts)[row_fits]
            slot0 = np.repeat(bc - free_open, counts)[row_fits]
            slots = slot0 + offs[row_fits]
            self._ids[b_rows, slots] = sorted_rows[row_fits]
            placed_b[row_fits] = b_rows
            placed_s[row_fits] = slots
            self._free[open_b[fits]] -= counts[fits]
            newly_full = fits & (free_open == counts)
            open_map[uniq[newly_full]] = -1

        # spill path: per-cluster loop over the remainder only
        for j in np.where(~fits)[0]:
            cl = uniq[j]
            rows = sorted_rows[starts[j]: starts[j] + counts[j]]
            pos = 0
            b = int(open_map[cl])
            while pos < len(rows):
                if b < 0 or self._free[b] == 0:
                    b = nb_cursor      # next spill bucket pre-allocated
                    nb_cursor += 1     # for THIS cluster (repeat order)
                take = min(len(rows) - pos, int(self._free[b]))
                slot0 = bc - int(self._free[b])
                self._ids[b, slot0: slot0 + take] = rows[pos: pos + take]
                placed_b[starts[j] + pos: starts[j] + pos + take] = b
                placed_s[starts[j] + pos: starts[j] + pos + take] = (
                    np.arange(slot0, slot0 + take))
                self._free[b] -= take
                pos += take
            open_map[cl] = b if self._free[b] > 0 else -1
        return list(zip(placed_b.tolist(), placed_s.tolist(),
                        sorted_rows.tolist()))

    def assign_host(self, prepared_rows: np.ndarray) -> np.ndarray:
        """Nearest-centroid assignment on the host (numpy)."""
        cs = prepared_rows.astype(np.float32) @ self._centroids.T
        if self.metric == "euclidean":
            cs = 2.0 * cs - (self._centroids ** 2).sum(-1)[None, :]
        return np.argmax(cs, axis=-1).astype(np.int32)

    # ---------------------------------------------------------------- search

    def _gather_layout(self, db) -> bool:
        """Quantized dtypes gather probes from the store's flat matrix (the
        bucket probes round queries to the bucket dtype and carry no
        per-row scales); layout='gather' forces it for cosine/dot."""
        if db.dtype in (torch.int8, torch.uint8):
            if self.layout_mode == "bucketized":
                logger.warning("ivf_layout='bucketized' unsupported for "
                               "quantized stores; using gather")
            return True
        if self.layout_mode == "gather" and self.metric == "euclidean":
            logger.warning("ivf_layout='gather' is cosine/dot only; "
                           "using bucketized")
            return False
        return self.layout_mode == "gather"

    def _ensure_device(self, db, sqnorms) -> None:
        if self._dev is not None and self._dev_rows == self._n:
            return
        self._dev = None     # free the old bucket copy before the gather
        dev = db.device
        ids = torch.from_numpy(self._ids).to(dev)
        mirror = {
            "centroids": torch.from_numpy(self._centroids).to(dev),
            "c_sqnorms": torch.from_numpy(
                (self._centroids ** 2).sum(-1).astype(np.float32)).to(dev),
            "ids": ids,
            "fills": torch.from_numpy(
                (self._ids.shape[1] - self._free).astype(np.int32)).to(dev),
            "bucket_cluster": torch.from_numpy(self._bucket_cluster).to(dev),
        }
        gather = self._gather_layout(db)
        if not gather:
            # dead slots gather row 0; only fills / ids >= 0 keep them out
            flat = torch.clamp(ids.reshape(-1), min=0).long()
            mirror["buckets"] = db[flat].reshape(
                self._ids.shape + (db.shape[1],))
            mirror["sqnorms"] = (sqnorms[flat].reshape(self._ids.shape)
                                 if sqnorms is not None else None)
        self._dev = mirror
        self._layout = "gather" if gather else "bucketized"
        # device bytes per bucket slot: the id table, plus the padded row
        # in the storage dtype when bucketized
        self._slot_bytes = 4 + (db.shape[1] * db.element_size()
                                if "buckets" in mirror else 0)
        self._dev_rows = self._n

    def search(self, queries, db, count: int, k: int,
               nprobe: int | None = None, sqnorms=None, scales=None):
        """(Q, k) global ids (numpy, -1 = empty slot) and keys (the
        store's maximize convention). queries must be PREPARED like db
        rows (int8/int4 stores pass f32 unit-norm queries and, for int4,
        the per-row scales; int8 keys come back in the raw x127 scale).
        On a CUDA device a bucketized index serves k <= 32 and one in
        the gather layout k <= 64 (``kernel_k_limit``): wider queries
        take the exact scan. The store sends the gather layout queries
        past k = 32 only where its ``ann_params["ivf_gather_large_k"]``
        is True (default False, the JAX store's routing).

        While tracing is on (``monitoring/tracing.py``) the current span
        (the store's ``index.search``) gains ``layout`` (``gather``,
        ``kernel`` or ``plain``), ``nprobe`` (the one used) and
        ``bucket_rows``; the probe after bucket selection is the span
        ``index.probe``."""
        if not self.built:
            raise RuntimeError("index not built")
        limit = kernel_k_limit(self._gather_layout(db))
        if k > limit and db.device.type == "cuda":
            raise ValueError(
                f"the IVF probe kernel supports k <= {limit} on a CUDA "
                f"device, got k={k}; use the exact scan")
        self._ensure_device(db, sqnorms)
        dev = self._dev
        nb = dev["ids"].shape[0]
        p = min(nprobe or self.nprobe, nb)
        q = torch.as_tensor(queries, dtype=torch.float32).to(db.device)
        if self._gather_layout(db):
            layout = "gather"
        elif k <= MAX_IVF_KERNEL_K:
            layout = "kernel"
        else:                             # a CPU tensor (checked above)
            layout = "plain"
        tracing.annotate("layout", layout)
        tracing.annotate("nprobe", p)
        tracing.annotate("bucket_rows", int(dev["ids"].shape[1]))
        keys, ids = to_host(*_select_and_probe(
            q, dev, db if layout == "gather" else None, scales, p,
            self.metric, k, layout))
        ids = np.where(keys == NEG_INF, -1, ids)
        return ids, keys

    # ----------------------------------------------------------- persistence

    def save(self, directory: str | Path) -> None:
        if not self.built:
            return
        atomic_save_npz(
            Path(directory) / IVF_FILE,
            centroids=self._centroids,
            ids=self._ids,
            bucket_cluster=self._bucket_cluster,
            free=self._free,
            meta=np.array([self._n, self.nprobe, self.dim,
                           self.train_iters], np.int64))

    def load(self, directory: str | Path) -> bool:
        path = Path(directory) / IVF_FILE
        if not path.exists():
            return False
        try:
            with np.load(path) as z:
                centroids = z["centroids"]
                ids = z["ids"]
                bucket_cluster = z["bucket_cluster"]
                free = z["free"]
                n, nprobe, dim, iters = z["meta"]
            if dim != self.dim:
                raise ValueError("IVF metadata mismatch")
            self._centroids = centroids
            self._ids = ids
            self._bucket_cluster = bucket_cluster
            self._free = free
            self._open = None
            self._n = int(n)
            self.nprobe = int(nprobe)
            self._dev = None
            self._dev_rows = 0
            return True
        except Exception:  # noqa: BLE001 — a corrupt index is rebuilt
            logger.exception("corrupt IVF index at %s; will rebuild", path)
            return False

    def get_stats(self) -> dict:
        nb, bc = (self._ids.shape if self._ids is not None else (0, 0))
        live = int((self._ids >= 0).sum()) if self._ids is not None else 0
        # before anything is materialized report 0 bytes of bucket copy;
        # after, the measured bytes per slot
        per_slot = self._slot_bytes
        if per_slot is None:
            per_slot = 4 if self._layout == "gather" else 0
        return {
            "type": "ivf",
            "layout": self._layout or "unmaterialized",
            "nodes": self._n,
            "clusters": (len(self._centroids)
                         if self._centroids is not None else 0),
            "nprobe": self.nprobe,
            "buckets": nb,
            "bucket_rows": bc,
            "fill_ratio": round(live / max(nb * bc, 1), 3),
            "build_time_s": round(self.build_time_s, 3),
            "memory_mb": round(nb * bc * per_slot / 2**20, 2),
        }
