"""TorchVectorStore — the exact flat store on a CUDA device.

Counterpart of ``tpu_vector_db/store/vector_store.py::TPUVectorStore``,
its flat path:

* the device matrix is CAPACITY-DOUBLED and preallocated, so appends
  write rows in place by slice assignment (the JAX package donates the
  buffer to ``dynamic_update_slice`` instead); the capacity rule is the
  same, so ``get_stats()["device_capacity"]`` matches;
* for cosine the device copy is normalized at add time; for euclidean
  the row squared-norms are kept beside it; the canonical float32 rows
  live on the host for persistence and rerank;
* metadata filters and tombstones become one f32 mask that the scan
  kernel reads beside the rows;
* every query is one launch of ``ops/cuda_scan.flat_topk`` and one packed
  device-to-host copy.

The store runs on ``device`` ("cuda" by default). It raises when CUDA is
absent unless the caller passes ``device="cpu"``, where the scan is the
kernel's plain version. The on-disk format is the JAX package's, so a
store saved by either package opens in the other.

ANN (``enable_ann=True``) belongs to the port's IVF slice and raises
NotImplementedError here. A query whose scan needs more than
``cuda_scan.MAX_K`` (1024) rows -- k, or k x rerank_oversample with
rerank -- raises ValueError; the JAX store serves it with its XLA scan.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.ops.cuda_scan import MAX_K, flat_topk
from tpu_vector_db_torch.ops.monitor import performance_monitor
from tpu_vector_db_torch.ops.quant4 import quantize_unit_rows
from tpu_vector_db_torch.ops.topk import NEG_INF
from tpu_vector_db_torch.store import persistence
from tpu_vector_db_torch.store.config import VectorStoreConfig
from tpu_vector_db_torch.utils.concurrency import RWLock
from tpu_vector_db_torch.utils.fs import (FileLock, atomic_save_npz,
                                          ensure_directory)
from tpu_vector_db_torch.utils.validation import validate_vector_shape

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int4": torch.uint8}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the store on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def metadata_matches(meta: dict, filt: dict) -> bool:
    """Exact-match dict-subset filter semantics."""
    return all(meta.get(k) == v for k, v in filt.items())


def _meta_hash(value) -> np.uint64:
    """Stable 64-bit hash of a metadata value (JSON canonical form)."""
    payload = json.dumps(value, sort_keys=True, default=str).encode()
    return np.uint64(int.from_bytes(
        hashlib.blake2b(payload, digest_size=8).digest(), "little"))


_MISSING = np.uint64(0xFFFFFFFFFFFFFFFF)


class MetadataColumnIndex:
    """Columnar hash index over metadata for vectorized exact-match filters.

    Each metadata key becomes a uint64 hash column; a filter is a numpy
    equality AND across columns. Hash collisions are resolved by an exact
    re-check of the returned top-k (``_format_results``)."""

    def __init__(self) -> None:
        self._columns: dict[str, np.ndarray] = {}
        self._count = 0
        self._cap = 0

    def _ensure(self, key: str) -> np.ndarray:
        col = self._columns.get(key)
        if col is None:
            col = np.full(max(self._cap, 1024), _MISSING, np.uint64)
            self._columns[key] = col
        return col

    def _grow(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(self._cap, 1024)
        while cap < n:
            cap *= 2
        for key, col in self._columns.items():
            new = np.full(cap, _MISSING, np.uint64)
            new[: len(col)] = col
            self._columns[key] = new
        self._cap = cap

    def extend(self, metadata: list[dict]) -> None:
        start = self._count
        self._count += len(metadata)
        self._grow(self._count)
        for i, meta in enumerate(metadata):
            for key, value in meta.items():
                col = self._ensure(key)
                if len(col) < self._cap:
                    new = np.full(self._cap, _MISSING, np.uint64)
                    new[: len(col)] = col
                    self._columns[key] = col = new
                col[start + i] = _meta_hash(value)

    def rebuild(self, metadata: list[dict]) -> None:
        self._columns.clear()
        self._count = 0
        self._cap = 0
        self.extend(metadata)

    def clear(self) -> None:
        self.rebuild([])

    def mask(self, filt: dict, out_size: int) -> np.ndarray:
        """(out_size,) bool; rows matching every (key, value) pair."""
        mask = np.zeros(out_size, np.bool_)
        live = min(self._count, out_size)
        if live == 0:
            return mask
        acc = np.ones(live, np.bool_)
        for key, value in filt.items():
            col = self._columns.get(key)
            if col is None:
                return mask  # key never seen -> nothing matches
            acc &= col[:live] == _meta_hash(value)
        mask[:live] = acc
        return mask


class TorchVectorStore:
    """One tenant store: (N, d) device matrix + host rows and metadata."""

    def __init__(self, store_path: str | Path,
                 config: VectorStoreConfig | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        # the persisted manifest is authoritative for an existing store
        manifest_cfg = persistence.load_manifest_config(store_path)
        if config is None:
            self.config = manifest_cfg or VectorStoreConfig()
        else:
            if manifest_cfg is not None:
                for field_ in ("dimension", "metric", "storage_dtype"):
                    have = getattr(manifest_cfg, field_)
                    want = getattr(config, field_)
                    if have != want:
                        raise persistence.StoreDimensionMismatch(
                            f"store at {store_path} was created with "
                            f"{field_}={have!r}, got config with "
                            f"{want!r}")
            self.config = config
        if self.config.enable_ann:
            raise NotImplementedError(
                "enable_ann=True needs the ANN index, which the port adds "
                "with its IVF slice (ops/kmeans.py, index/ivf.py and the "
                "IVF probe kernel); this store serves the exact flat scan "
                "only")
        self.store_path = Path(store_path)
        ensure_directory(self.store_path)
        self._lock = threading.RLock()
        # queries are READERS, mutations are WRITERS: in-place appends and
        # buffer swaps must not overlap a launched scan
        self._rw = RWLock()
        self._file_lock = FileLock(self.store_path)
        self._dirty = False

        d = self.config.dimension
        # int4 packs two components per byte along d; d pads to 256 so
        # the packed width stays a multiple of 128 bytes
        self._quant4 = self.config.storage_dtype == "int4"
        self._pad_to = 256 if self._quant4 else 128
        self._d_pad = ((d + self._pad_to - 1) // self._pad_to) * self._pad_to
        self._block = int(self.config.block_rows)
        self._dtype = _DTYPES[self.config.storage_dtype]

        # host canonical state
        self._count = 0
        self._host_cap = 0
        self._host_buf: np.ndarray | None = None  # (host_cap, d) float32
        self._metadata: list[dict] = []
        self._meta_index = MetadataColumnIndex()
        # tombstones: stable ids; deleted rows drop out of the scan
        # through the same mask as filters; compact() reclaims space
        self._deleted: set[int] = set()
        self._live_mask_version = 0
        self._live_mask_cache: tuple | None = None  # ((cap, ver), host)
        self._live_mask_dev: tuple | None = None    # ((cap, ver), device)

        # device state (created lazily in _reset_device)
        self._cap = 0
        self._db: torch.Tensor | None = None        # (cap, d_pad) prepared
        self._sqnorms: torch.Tensor | None = None   # (cap,) f32, euclidean
        self._scales: torch.Tensor | None = None    # (cap,) f32, int4 only

        self._load()

    # ------------------------------------------------------------------ util

    @property
    def metric(self) -> str:
        return self.config.metric

    def __len__(self) -> int:
        return self._count - len(self._deleted)

    @property
    def vector_count(self) -> int:
        """LIVE vectors (tombstoned rows excluded; ids stay stable)."""
        return self._count - len(self._deleted)

    def _capacity_for(self, n: int) -> int:
        cap = max(self._block, self.config.initial_capacity)
        while cap < n:
            cap *= 2
        return ((cap + self._block - 1) // self._block) * self._block

    def _prepare_block(self, x: torch.Tensor):
        """float32 (n,d) rows on the device -> rows (n, d_pad) in the
        storage dtype, plus (n,) f32 scales for int4 (else None)."""
        if self.metric == "cosine":
            x = D.l2_normalize(x)
        x = D.pad_dim(x, multiple=self._pad_to)
        if self.config.storage_dtype in ("int8", "int4"):
            return quantize_unit_rows(x, self.config.storage_dtype)
        return x.to(self._dtype), None

    def _write_rows(self, arr: np.ndarray, offset: int) -> None:
        """Upload float32 host rows once, prepare them and write them in
        place at ``offset`` (rows, int4 scales, euclidean sqnorms)."""
        n = arr.shape[0]
        x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            self.device)
        block, scales = self._prepare_block(x)
        self._db[offset: offset + n] = block
        if self._scales is not None:
            self._scales[offset: offset + n] = scales
        if self._sqnorms is not None:
            self._sqnorms[offset: offset + n] = torch.sum(x * x, dim=-1)

    def _reset_device(self, capacity: int) -> None:
        """(Re)build the device buffers from host state at a new capacity."""
        self._db = self._sqnorms = self._scales = None  # free before alloc
        self._cap = capacity
        cols = self._d_pad // 2 if self._quant4 else self._d_pad
        self._db = torch.zeros((capacity, cols), dtype=self._dtype,
                               device=self.device)
        if self.metric == "euclidean":
            self._sqnorms = torch.zeros(capacity, device=self.device)
        if self._quant4:
            self._scales = torch.zeros(capacity, device=self.device)
        if self._count:
            self._write_rows(self._host_buf[: self._count], 0)

    def _ensure_host_cap(self, n: int) -> None:
        if self._host_buf is None or self._host_cap < n:
            new_cap = self._capacity_for(n)
            buf = np.zeros((new_cap, self.config.dimension), np.float32)
            if self._count:
                buf[: self._count] = self._host_buf[: self._count]
            self._host_buf = buf
            self._host_cap = new_cap

    # ------------------------------------------------------------- mutation

    def add_vectors(self, vectors, metadata: list[dict] | None = None) -> dict:
        """Append rows (+ metadata). Returns counts."""
        arr = validate_vector_shape(vectors, self.config.dimension)
        n = arr.shape[0]
        if metadata is None:
            metadata = [{} for _ in range(n)]
        if len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != vectors {n}")
        t_add = time.perf_counter()
        with self._lock, self._rw.write():
            new_count = self._count + n
            grow = self._db is None or new_count > self._cap
            if grow:
                # fail BEFORE mutating host state
                self.config.check_device_budget(
                    self._capacity_for(new_count), device=self.device)
            self._ensure_host_cap(new_count)
            self._host_buf[self._count: new_count] = arr
            self._metadata.extend(metadata)
            self._meta_index.extend(metadata)
            if grow:
                self._count = new_count
                self._reset_device(self._capacity_for(new_count))
            else:
                self._write_rows(arr, self._count)
                self._count = new_count
            self._dirty = True
            if self.config.persist_mode == "sync":
                self._save()
        performance_monitor.record("add_vectors", time.perf_counter() - t_add)
        return {"added": n, "total": self._count}

    def delete_vectors(self, indices) -> dict:
        """Tombstone rows by id — ids stay STABLE (no reindexing)."""
        with self._lock, self._rw.write():
            idx = np.unique(np.asarray(indices, np.int64))
            if idx.size and (idx[0] < 0 or idx[-1] >= self._count):
                raise ValueError(
                    f"delete indices out of range [0, {self._count})")
            before = len(self._deleted)
            self._deleted.update(int(i) for i in idx)
            deleted = len(self._deleted) - before
            if deleted:
                self._live_mask_version += 1
                self._dirty = True
                if self.config.persist_mode == "sync":
                    self._save()
            return {"deleted": deleted,
                    "live": self._count - len(self._deleted)}

    def compact(self, want_remap: bool = True) -> dict:
        """Physically remove tombstoned rows and rebuild the device
        buffers. Returns the id remap (old -> new) of the ids that MOVED
        (old >= the first deleted id); want_remap=False skips it."""
        with self._lock, self._rw.write():
            if not self._deleted:
                return {"compacted": 0, "live": self._count, "remap": {}}
            live = np.ones(self._count, bool)
            live[np.fromiter(self._deleted, np.int64,
                             len(self._deleted))] = False
            keep = np.nonzero(live)[0]
            remap = {}
            if want_remap:
                first_del = min(self._deleted)
                moved = np.nonzero(keep >= first_del)[0]
                remap = {int(keep[j]): int(j) for j in moved}
            n_removed = self._count - len(keep)
            self._host_buf[: len(keep)] = self._host_buf[keep]
            self._metadata = [self._metadata[i] for i in keep]
            self._meta_index.rebuild(self._metadata)
            self._count = len(keep)
            self._deleted.clear()
            self._live_mask_version += 1
            self._live_mask_cache = None
            self._live_mask_dev = None
            self._reset_device(self._capacity_for(max(self._count, 1)))
            self._dirty = True
            if self.config.persist_mode == "sync":
                self._save()
            return {"compacted": n_removed, "live": self._count,
                    "remap": remap}

    def _live_host_mask(self) -> np.ndarray | None:
        """(cap,) float32 0/1 mask of live rows, or None when nothing is
        deleted. Cached per (capacity, deletion version)."""
        if not self._deleted:
            return None
        key = (self._cap, self._live_mask_version)
        if self._live_mask_cache is None or \
                self._live_mask_cache[0] != key:
            mask = np.ones((self._cap,), np.float32)
            mask[np.fromiter(self._deleted, np.int64,
                             len(self._deleted))] = 0.0
            self._live_mask_cache = (key, mask)
        return self._live_mask_cache[1]

    def _device_live_mask(self) -> torch.Tensor | None:
        """Device copy of the live mask: one upload per (capacity,
        deletion version), not per query."""
        lm = self._live_host_mask()
        if lm is None:
            return None
        key = (self._cap, self._live_mask_version)
        if self._live_mask_dev is None or self._live_mask_dev[0] != key:
            self._live_mask_dev = (key, self._filter_mask(lm))
        return self._live_mask_dev[1]

    def clear(self) -> None:
        """Drop all state and wipe the directory."""
        with self._lock, self._rw.write():
            if self.store_path.exists():
                shutil.rmtree(self.store_path, ignore_errors=True)
            ensure_directory(self.store_path)
            self._count = 0
            self._host_cap = 0
            self._host_buf = None
            self._metadata = []
            self._meta_index.clear()
            self._cap = 0
            self._db = None
            self._sqnorms = None
            self._scales = None
            self._deleted = set()
            self._live_mask_cache = None
            self._live_mask_dev = None
            self._dirty = False

    # ---------------------------------------------------------------- query

    def _filter_mask(self, host_mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(host_mask, np.float32)).to(self.device)

    def _query_mask(self, filter_metadata: dict | None
                    ) -> torch.Tensor | None:
        """Device (cap,) mask of the rows a query may return: the filter
        mask times the live mask, or the cached live mask alone."""
        if not filter_metadata:
            return self._device_live_mask()
        host_mask = self._meta_index.mask(filter_metadata, self._cap)
        live_mask = self._live_host_mask()
        if live_mask is not None:
            host_mask = host_mask * live_mask
        return self._filter_mask(host_mask)

    def _scan_inputs(self, queries: np.ndarray,
                     filter_mask: torch.Tensor | None) -> dict:
        """The arguments of ``flat_topk`` but k, for host queries."""
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q = D.l2_normalize(q)
        return dict(queries=D.pad_dim(q, multiple=self._pad_to), db=self._db,
                    count=self._count, metric=self.metric,
                    db_sqnorms=self._sqnorms, filter_mask=filter_mask,
                    db_scales=self._scales)

    def _flat_topk(self, queries: np.ndarray, k: int,
                   filter_mask: torch.Tensor | None):
        """One scan launch and ONE device-to-host copy: keys viewed as
        int32 beside the ids. Returns host (keys f32, ids i32)."""
        keys, idx = flat_topk(k=k, **self._scan_inputs(queries, filter_mask))
        packed = torch.cat([keys.view(torch.int32), idx], dim=1).cpu().numpy()
        keys = np.ascontiguousarray(packed[:, :k]).view(np.float32)
        if self.config.storage_dtype == "int8":
            keys = keys * (1.0 / 127.0)  # undo the fixed quantizer scale
        return keys, packed[:, k:]

    def _format_results(self, keys_row: np.ndarray, idx_row: np.ndarray,
                        k: int, filter_metadata: dict | None = None):
        indices, scores, metas = [], [], []
        for key, i in zip(keys_row, idx_row):
            if key == NEG_INF or len(indices) >= k:
                continue
            meta = self._metadata[int(i)]
            # exact re-check: the filter mask is hash-based
            if filter_metadata and not metadata_matches(meta, filter_metadata):
                continue
            if self.metric == "euclidean":
                raw = float(np.sqrt(max(-key, 0.0)))
            elif self.metric == "cosine":
                # bf16 rounding can lift a unit self-similarity past 1
                raw = float(np.clip(key, -1.0, 1.0))
            else:
                raw = float(key)
            indices.append(int(i))
            scores.append(raw)
            metas.append(meta)
        return indices, scores, metas

    def query(self, query_vector, k: int = 10,
              filter_metadata: dict | None = None, use_ann: bool = True,
              rerank: bool = False):
        """Top-k search for one vector. Returns (indices, raw_scores,
        metadata); raw scores follow ops/distance.py's convention."""
        arr = validate_vector_shape(query_vector, self.config.dimension)
        if arr.shape[0] != 1:
            raise ValueError("query() takes one vector; use batch_query()")
        return self.batch_query(arr, k=k, filter_metadata=filter_metadata,
                                use_ann=use_ann, rerank=rerank)[0]

    def batch_query(self, query_vectors, k: int = 10,
                    filter_metadata: dict | None = None, use_ann: bool = True,
                    rerank: bool = False):
        """Batched top-k: list of (indices, raw_scores, metadata) per query.

        rerank=True (lossy storage dtypes bfloat16/int8/int4): the scan
        oversamples k * ann_params["rerank_oversample"] (default 4)
        candidates, which are re-scored against the ORIGINAL f32 host
        rows. No-op on float32 stores. ``use_ann`` is accepted for the
        JAX store's signature; this store has no ANN index."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        arr = validate_vector_shape(query_vectors, self.config.dimension)
        n_q = arr.shape[0]
        # pad the batch to a power of two, as the JAX store does, so both
        # stores see the same query shapes
        q_pad = 1
        while q_pad < n_q:
            q_pad *= 2
        if q_pad != n_q:
            arr = np.concatenate(
                [arr, np.repeat(arr[:1], q_pad - n_q, axis=0)])
        with self._rw.read():
            live_total = self._count - len(self._deleted)
            if live_total == 0:
                return [([], [], []) for _ in range(n_q)]
            k_eff = min(int(k), live_total)
            rerank_active = (rerank and
                             self.config.storage_dtype != "float32")
            over = int(self.config.ann_params.get("rerank_oversample", 4))
            k_engine = (min(self._count, k_eff * max(over, 1))
                        if rerank_active else k_eff)
            if k_engine > MAX_K:
                raise ValueError(
                    f"the exact scan returns at most {MAX_K} rows per "
                    f"query; this call needs {k_engine} (k={k_eff}"
                    + (f" x rerank_oversample {over})" if rerank_active
                       else ")"))

            t0 = time.perf_counter()
            mask = self._query_mask(filter_metadata)
            keys, idx = self._flat_topk(arr, k_engine, mask)
            performance_monitor.record("flat_scan_topk",
                                       time.perf_counter() - t0)
            out = [self._format_results(keys[i], idx[i], k_engine,
                                        filter_metadata)
                   for i in range(n_q)]
            return (self._rerank_exact(arr, out, k_eff)
                    if rerank_active else out)

    def _rerank_exact(self, queries: np.ndarray, results: list,
                      k: int) -> list:
        """Re-score each query's candidates against the ORIGINAL f32 rows
        on the host and return the exact top-k in the store's raw-score
        convention (cosine: clipped similarity; euclidean: distance,
        ascending; dot: score)."""
        out = []
        for qi, (indices, _scores, metas) in enumerate(results):
            if not indices:
                out.append((indices, _scores, metas))
                continue
            rows = self._host_buf[np.asarray(indices)].astype(np.float32)
            q = queries[qi].astype(np.float32)
            if self.metric == "cosine":
                rows = rows / np.maximum(
                    np.linalg.norm(rows, axis=1, keepdims=True), 1e-8)
                q = q / max(float(np.linalg.norm(q)), 1e-8)
                exact = np.clip(rows @ q, -1.0, 1.0)
                order = np.argsort(-exact)[:k]
            elif self.metric == "euclidean":
                exact = np.linalg.norm(rows - q, axis=1)
                order = np.argsort(exact)[:k]
            else:  # dot
                exact = rows @ q
                order = np.argsort(-exact)[:k]
            out.append((
                [indices[j] for j in order],
                [float(exact[j]) for j in order],
                [metas[j] for j in order]))
        return out

    # ------------------------------------------------------------- lifecycle

    def optimize(self) -> dict:
        """Compact tombstones and re-pack the device buffers to minimal
        capacity. Compaction REMAPS row ids (see compact())."""
        compacted = 0
        if self._deleted:
            compacted = self.compact(want_remap=False)["compacted"]
        t0 = time.perf_counter()
        with self._lock, self._rw.write():
            target = self._capacity_for(max(self._count, 1))
            if target != self._cap and self._count:
                self._reset_device(target)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"optimized": True, "capacity": self._cap,
                "count": self._count, "compacted": compacted,
                "duration_ms": (time.perf_counter() - t0) * 1e3}

    def warmup(self, batch: int = 8, k: int = 10) -> dict:
        """Run the query path once per batch shape ahead of traffic (on a
        CUDA store the first call also builds the scan kernel)."""
        with self._lock:
            if self._count == 0:
                return {"warmed": False, "reason": "empty store"}
            t0 = time.perf_counter()
            dummy = np.zeros((batch, self.config.dimension), np.float32)
            dummy[:, 0] = 1.0
            self.batch_query(dummy, k=min(k, self._count))
            self.batch_query(dummy[:1], k=min(k, self._count))
            return {"warmed": True,
                    "duration_ms": (time.perf_counter() - t0) * 1e3}

    def flush(self) -> None:
        with self._lock:
            if self._dirty and self.config.persist_mode != "off":
                self._save()

    def close(self) -> None:
        self.flush()

    def _save(self) -> None:
        live = (self._host_buf[: self._count] if self._host_buf is not None
                else np.zeros((0, self.config.dimension), np.float32))
        with self._file_lock:
            persistence.save_store(
                self.store_path, live, self._metadata, self.config)
            # tombstones persist beside the main files so ids stay stable
            tpath = self.store_path / "tombstones.npz"
            if self._deleted:
                atomic_save_npz(tpath, ids=np.fromiter(
                    sorted(self._deleted), np.int64, len(self._deleted)))
            elif tpath.exists():
                tpath.unlink()
        self._dirty = False

    def _load(self) -> None:
        vectors, metadata = persistence.load_store(self.store_path,
                                                   self.config)
        if vectors is None or vectors.shape[0] == 0:
            return
        n = vectors.shape[0]
        self._ensure_host_cap(n)
        self._host_buf[:n] = vectors
        self._count = n
        self._metadata = metadata
        self._meta_index.rebuild(metadata)
        tpath = self.store_path / "tombstones.npz"
        if tpath.exists():
            try:
                with np.load(tpath) as z:
                    self._deleted = {int(i) for i in z["ids"]
                                     if 0 <= i < n}
            except (OSError, ValueError, KeyError):  # corrupt: all live
                logger.exception("corrupt tombstones at %s; ignoring", tpath)
                self._deleted = set()
        self._reset_device(self._capacity_for(n))

    def get_vectors(self, indices: list[int] | None = None) -> np.ndarray:
        """Fetch rows by id (all LIVE rows when indices is None).
        Tombstoned or out-of-range ids raise KeyError."""
        with self._lock:
            if indices is None:
                live = (self._host_buf[: self._count] if self._count else
                        np.zeros((0, self.config.dimension), np.float32))
                if not self._deleted:
                    return live.copy()
                keep = np.array([i for i in range(self._count)
                                 if i not in self._deleted], np.int64)
                return live[keep]
            idx = np.asarray(indices, np.int64)
            bad = [int(i) for i in idx
                   if i < 0 or i >= self._count or int(i) in self._deleted]
            if bad:
                raise KeyError(
                    f"ids not found (deleted or out of range): {bad[:10]}")
            return self._host_buf[idx].copy()

    def get_metadata(self, indices: list[int]) -> list[dict]:
        """Metadata for live ids (same validation as get_vectors)."""
        with self._lock:
            bad = [int(i) for i in indices
                   if i < 0 or i >= self._count or int(i) in self._deleted]
            if bad:
                raise KeyError(
                    f"ids not found (deleted or out of range): {bad[:10]}")
            return [self._metadata[int(i)] for i in indices]

    def get_stats(self) -> dict:
        with self._lock:
            device_cols = self._d_pad // 2 if self._quant4 else self._d_pad
            device_mb = (self._cap * device_cols * self._dtype.itemsize) / 2**20
            host_mb = (self._host_cap * self.config.dimension * 4) / 2**20
            return {
                "vector_count": self._count - len(self._deleted),
                "deleted_count": len(self._deleted),
                "dimension": self.config.dimension,
                "metric": self.metric,
                "index_type": "flat",
                "index_type_requested": self.config.ann_params.get(
                    "index_type", "auto"),
                "storage_dtype": self.config.storage_dtype,
                "device_capacity": self._cap,
                "ann_recall_estimate": None,
                "memory_usage_mb": round(device_mb + host_mb, 3),
            }


def create_vector_store(store_path: str | Path,
                        dimension: int = 384, metric: str = "cosine",
                        device: str | torch.device = "cuda",
                        **kwargs) -> TorchVectorStore:
    """Factory with the JAX package's signature plus ``device``."""
    cfg = VectorStoreConfig(dimension=dimension, metric=metric, **kwargs)
    return TorchVectorStore(store_path, cfg, device=device)
