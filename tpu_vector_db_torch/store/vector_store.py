"""TorchVectorStore — the vector store on a CUDA device.

Counterpart of ``tpu_vector_db/store/vector_store.py::TPUVectorStore``:

* the device matrix is CAPACITY-DOUBLED and preallocated, so appends
  write rows in place by slice assignment (the JAX package donates the
  buffer to ``dynamic_update_slice`` instead); the capacity rule is the
  same, so ``get_stats()["device_capacity"]`` matches; host rows go up
  in blocks of at most ``UPLOAD_BLOCK_BYTES`` of f32 (the JAX store
  uploads them in one piece), so a store that grows, compacts or reopens
  at 16M x 768 needs no 48 GiB f32 copy on the card;
* for cosine the device copy is normalized at add time; for euclidean
  the row squared-norms are kept beside it; the canonical float32 rows
  live on the host for persistence and rerank;
* metadata filters and tombstones become one f32 mask that the scan
  kernel reads beside the rows;
* an exact query is one launch of ``ops/cuda_scan.flat_topk`` (any k)
  and one packed device-to-host copy;
* with ``enable_ann=True`` the store keeps an ANN index: IVF
  (``index/ivf.py``; ``index_type="auto"`` picks it from
  ``auto_flat_rows`` rows) or
  the beam graph (``index/beam_graph.py``, ``index_type="beam_graph"``),
  and routes each query as the JAX store does: to the index, or to the
  exact scan for IVF past k = 32, batches of 32 and more (auto mode),
  filters that keep few rows, heavily deleted stores, a stale index and a
  low sampled recall. The index is refreshed on add outside the store
  lock (the graph extends by insertion, with no rebuild), rebuilt by
  ``optimize()``, and saved beside the store as ``ann_ivf.npz`` or
  ``ann_graph.npz``. ``ann_params["build_backend"]`` keeps the JAX
  values: ``"tpu"`` (the default) builds the graph on the store's device,
  ``"cpu"``/``"auto"`` with the native C++ builder
  (``native/graph_builder.cpp``) when it is available, else on the device.

The store runs on ``device`` ("cuda" by default). It raises when CUDA is
absent unless the caller passes ``device="cpu"``, where every kernel's
plain version runs instead. The on-disk format, the IVF sidecar
included, is the JAX package's, so a store saved by either package opens
in the other and serves its index without a rebuild.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import shutil
import threading
import time
from itertools import compress
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex
from tpu_vector_db_torch.index.ivf import IVFIndex, kernel_k_limit
from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops.cuda_scan import flat_topk
from tpu_vector_db_torch.ops.quant4 import quantize_unit_rows
from tpu_vector_db_torch.ops.topk import NEG_INF, to_host
from tpu_vector_db_torch.store import persistence
from tpu_vector_db_torch.store.config import (VectorStoreConfig, ann_param,
                                             index_args)
from tpu_vector_db_torch.utils.concurrency import RWLock
from tpu_vector_db_torch.utils.fs import (FileLock, atomic_save_npz,
                                          ensure_directory)
from tpu_vector_db_torch.utils.validation import validate_vector_shape

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int4": torch.uint8}

# the most float32 bytes of host rows one device upload carries: a store
# of 16M x 768 rows writes 192 blocks of 256 MiB, not one 48 GiB tensor
# (and its prepared copy of the same size)
UPLOAD_BLOCK_BYTES = 256 * 2**20


def upload_blocks(n: int, d: int) -> list[tuple[int, int]]:
    """[start, stop) ranges covering n rows of d float32 components, each
    at most ``UPLOAD_BLOCK_BYTES`` (at least one row), in near-equal
    sizes. Every row is prepared alone (``ops/distance.py``'s row
    reductions give a row the same bits in a block of any size), so any
    split writes the bytes of a one-shot write."""
    per = max(1, UPLOAD_BLOCK_BYTES // (4 * max(d, 1)))
    parts = max(1, -(-n // per))
    bounds = [n * i // parts for i in range(parts + 1)]
    return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


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
    re-check of the returned top-k (``_format_batch``)."""

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
        # hashes of this call's str/int/bool values, each hashed once
        # (floats are not kept: -0.0 == 0.0 but their hashes differ)
        seen: dict = {}
        for i, meta in enumerate(metadata):
            for key, value in meta.items():
                col = self._ensure(key)
                if len(col) < self._cap:
                    new = np.full(self._cap, _MISSING, np.uint64)
                    new[: len(col)] = col
                    self._columns[key] = col = new
                if type(value) in (str, int, bool):
                    h = seen.get((type(value), value))
                    if h is None:
                        h = seen[(type(value), value)] = _meta_hash(value)
                else:
                    h = _meta_hash(value)
                col[start + i] = h

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
        self.store_path = Path(store_path)
        ensure_directory(self.store_path)
        self._lock = threading.RLock()
        # queries are READERS, mutations are WRITERS: in-place appends and
        # buffer swaps must not overlap a launched scan. Lock order:
        # _lock -> rw.write; rw.read -> _ann_build_lock; never the reverse
        self._rw = RWLock()
        # serializes ANN builds and extends apart from the store lock, so
        # queries never wait behind an index build: add_vectors appends
        # under _lock, then refreshes the index under this lock only, and
        # queries route to the exact scan while the index is stale.
        # Reentrant: admin paths (optimize/compact) nest refreshes.
        self._ann_build_lock = threading.RLock()
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
        # metadata.jsonl of the rows of _metadata encoded so far: rows are
        # only appended to one list (compact, clear and load replace it),
        # so a save encodes only the rows added since the last one
        self._jsonl: tuple[list, int, bytearray] = ([], 0, bytearray())
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

        # ANN index, built lazily
        self._ann: IVFIndex | BeamGraphIndex | None = None
        self._ann_stale = True
        # index_type='auto': resolved from the store size, re-checked on
        # every full (re)build; see _auto_pick_kind
        self._auto_kind: str | None = None
        # sampled-recall guard after builds (_ann_self_check)
        self._ann_recall_estimate: float | None = None
        self._ann_low_recall = False
        self._ann_checked_at = 0

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
        """Write float32 host rows in place at ``offset`` in blocks of at
        most ``UPLOAD_BLOCK_BYTES`` of f32 (``upload_blocks``), so an
        upload never holds more than one block's f32 copy and its
        prepared copy on the device, whatever the store's size."""
        for start, stop in upload_blocks(arr.shape[0], arr.shape[1]):
            self._write_block(arr[start:stop], offset + start)

    def _write_block(self, arr: np.ndarray, offset: int) -> None:
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
            self._sqnorms[offset: offset + n] = D.row_sqnorms(x)

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

    def _check_device_budget(self, capacity: int) -> None:
        """Raise StoreCapacityError if ``capacity`` rows do not fit on
        the store's device."""
        self.config.check_device_budget(capacity, device=self.device)

    def _ensure_host_cap(self, n: int) -> None:
        if self._host_buf is None or self._host_cap < n:
            new_cap = self._capacity_for(n)
            buf = np.zeros((new_cap, self.config.dimension), np.float32)
            if self._count:
                buf[: self._count] = self._host_buf[: self._count]
            self._host_buf = buf
            self._host_cap = new_cap

    # ------------------------------------------------------------- mutation

    @tracing.traced("store.add")
    def add_vectors(self, vectors, metadata: list[dict] | None = None) -> dict:
        """Append rows (+ metadata). Returns counts."""
        arr = validate_vector_shape(vectors, self.config.dimension)
        n = arr.shape[0]
        if metadata is None:
            metadata = [{} for _ in range(n)]
        if len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != vectors {n}")
        with self._lock, self._rw.write():
            new_count = self._count + n
            grow = self._db is None or new_count > self._cap
            if grow:
                # fail BEFORE mutating host state
                self._check_device_budget(self._capacity_for(new_count))
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
            self._ann_stale = True
            self._dirty = True
            if self.config.persist_mode == "sync":
                self._save()
        # the index refresh runs OUTSIDE the store lock: queries meanwhile
        # use the previous index or, while it is stale, the exact scan,
        # which already covers the new rows
        if self.config.enable_ann:
            self._refresh_ann_tail()
        return {"added": n, "total": self._count}

    def _refresh_ann_tail(self) -> None:
        """Index the appended tail without holding the store lock.

        The extend range comes from the index's own size, so back-to-back
        adds queue on _ann_build_lock and the first holder indexes every
        row appended so far. Holds rw.read for the build: queries stay
        live, while a concurrent add (a writer) waits."""
        with self._rw.read(), self._ann_build_lock:
            if not self._ann_stale:
                return  # a previous holder already covered our rows
            if (self._ann is not None and self._ann_kind != "flat"
                    and self._ann.built):
                start = self._ann.size
            else:
                start = 0
            self._refresh_ann(incremental_from=start or None)

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

    def compact(self, rebuild_ann: bool = True,
                want_remap: bool = True) -> dict:
        """Physically remove tombstoned rows and rebuild the device
        buffers and any ANN index (rebuild_ann=False leaves the rebuild to
        the caller). Returns the id remap (old -> new) of the ids that
        MOVED (old >= the first deleted id); want_remap=False skips it."""
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
            # routing and recall state came from the old corpus
            self._reset_ann_state()
            self._reset_device(self._capacity_for(max(self._count, 1)))
            if rebuild_ann and self.config.enable_ann and self._count:
                self._refresh_ann()
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
            # a latched low-recall verdict must not outlive the corpus
            self._reset_ann_state()
            self._deleted = set()
            self._live_mask_cache = None
            self._live_mask_dev = None
            self._dirty = False

    def _reset_ann_state(self) -> None:
        self._ann = None
        self._ann_stale = True
        self._auto_kind = None
        self._ann_low_recall = False
        self._ann_checked_at = 0
        self._ann_recall_estimate = None

    # ---------------------------------------------------------------- query

    def _filter_mask(self, host_mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(host_mask, np.float32)).to(self.device)

    def _host_query_mask(self, filter_metadata: dict | None
                         ) -> np.ndarray | None:
        """Host (cap,) mask of the rows a query may return: the filter
        mask times the live mask, the live mask alone, or None (all)."""
        live_mask = self._live_host_mask()
        if not filter_metadata:
            return live_mask
        host_mask = self._meta_index.mask(filter_metadata, self._cap)
        return host_mask if live_mask is None else host_mask * live_mask

    def _query_mask(self, filter_metadata: dict | None,
                    host_mask: np.ndarray | None = None
                    ) -> torch.Tensor | None:
        """Device copy of ``_host_query_mask`` (``host_mask`` when the
        caller has it already); without a filter, the cached live mask."""
        if not filter_metadata:
            return self._device_live_mask()
        if host_mask is None:
            host_mask = self._host_query_mask(filter_metadata)
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

    def _exact_topk(self, **scan_inputs):
        """Device (keys, ids) of the exact scan over ``_scan_inputs``:
        one ``flat_topk`` call."""
        return flat_topk(**scan_inputs)

    def _flat_topk(self, queries: np.ndarray, k: int,
                   filter_mask: torch.Tensor | None):
        """One scan launch and ONE device-to-host copy: keys viewed as
        int32 beside the ids. Returns host (keys f32, ids i32)."""
        # the copy to the host waits for the scan: the span is synchronised
        with tracing.span("store.scan", k=k):
            keys, idx = self._exact_topk(
                k=k, **self._scan_inputs(queries, filter_mask))
            keys, idx = to_host(keys, idx)
        if self.config.storage_dtype == "int8":
            keys = keys * (1.0 / 127.0)  # undo the fixed quantizer scale
        return keys, idx

    def _format_batch(self, keys: np.ndarray, ids: np.ndarray, k: int,
                      valid: np.ndarray, filter_metadata: dict | None):
        """A batch's host (keys, ids) block as one (indices, raw_scores,
        metadata) tuple a row: the entries ``valid`` keeps, in order, at
        most k of them, each re-checked against ``filter_metadata`` when
        one is given. Scores are converted a whole array at a time, in
        the keys' dtype, so each is the Python float that ``np.clip`` /
        ``np.sqrt`` of its one key would give (ops/distance.py's raw-score
        convention)."""
        with tracing.span("store.format", host_only=True):
            if self.metric == "euclidean":
                # -key floored at 0 by a compare, not np.maximum: a key of
                # exactly 0.0 keeps its distance of -0.0
                scores = -keys
                scores[scores < 0] = 0
                np.sqrt(scores, out=scores)
            elif self.metric == "cosine":
                # bf16 rounding can lift a unit self-similarity past 1
                scores = np.clip(keys, -1.0, 1.0)
            else:
                scores = keys
            metadata = self._metadata
            full = valid.all(axis=1).tolist()
            out, size, rechecked = [], 0, 0
            for r, (row_ids, row_scores) in enumerate(
                    zip(ids.tolist(), scores.tolist())):
                if not full[r]:
                    keep = valid[r].tolist()
                    row_ids = list(compress(row_ids, keep))
                    row_scores = list(compress(row_scores, keep))
                if not filter_metadata:
                    row_ids, row_scores = row_ids[:k], row_scores[:k]
                    out.append((row_ids, row_scores,
                                [metadata[i] for i in row_ids]))
                    size += len(row_ids)
                    continue
                # exact re-check: the filter mask is hash-based
                indices, kept, metas = [], [], []
                for i, score in zip(row_ids, row_scores):
                    if len(indices) >= k:
                        break
                    meta = metadata[i]
                    rechecked += 1
                    if metadata_matches(meta, filter_metadata):
                        indices.append(i)
                        kept.append(score)
                        metas.append(meta)
                out.append((indices, kept, metas))
                size += len(indices)
            tracing.annotate("size", size)
            tracing.annotate("rechecked", rechecked)
        return out

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

    @tracing.traced("store.batch_query")
    def batch_query(self, query_vectors, k: int = 10,
                    filter_metadata: dict | None = None, use_ann: bool = True,
                    rerank: bool = False):
        """Batched top-k: list of (indices, raw_scores, metadata) per query.

        rerank=True (lossy storage dtypes bfloat16/int8/int4): the engine
        oversamples k * ann_params["rerank_oversample"] candidates, which
        are re-scored against the ORIGINAL f32 host rows. No-op on float32
        stores. use_ann=False forces the exact scan on an ANN store; an ANN
        query that fails falls back to the exact scan with a warning, as in
        the JAX store."""
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
        tracing.annotate("k", int(k))
        with self._rw.read():
            live_total = self._count - len(self._deleted)
            if live_total == 0:
                return [([], [], []) for _ in range(n_q)]
            k_eff = min(int(k), live_total)
            rerank_active = (rerank and
                             self.config.storage_dtype != "float32")
            p = self.config.ann_params
            over = int(ann_param(p, "rerank_oversample"))
            k_engine = (min(self._count, k_eff * max(over, 1))
                        if rerank_active else k_eff)

            # routing: ANN only past ann_min_rows (0: always, when enabled)
            min_rows = ann_param(p, "ann_min_rows")
            # IVF large-k: past the probe kernel's k = 32 the exact big-k
            # scan serves the query; ivf_gather_large_k lets an index in
            # the gather layout keep it up to its kernel's k = 64.
            # Tombstones post-filter out of ANN results like filters, and
            # share their oversample
            fetch_k = self._post_filter_fetch_k(k_engine,
                                                bool(filter_metadata))
            gather_k = bool(ann_param(p, "ivf_gather_large_k")
                            and isinstance(self._ann, IVFIndex)
                            and self._ann._gather_layout(self._db))
            ivf_large_k = (self._ann_kind == "ivf"
                           and fetch_k > kernel_k_limit(gather_k))
            # a filter that keeps few rows, or a mostly deleted store,
            # would post-filter the ANN oversample to fewer than k hits;
            # the masked exact scan is exact there
            host_mask = self._host_query_mask(filter_metadata)
            low_sel_filter = False
            if filter_metadata:
                live = float(host_mask[:max(self._count, 1)].sum())
                low_sel_filter = live < ann_param(
                    p, "filter_exact_selectivity") * self._count
            elif self._deleted:
                live_frac = live_total / max(self._count, 1)
                low_sel_filter = live_frac < ann_param(
                    p, "deleted_exact_live_frac")
            # auto mode: a large batch below the row crossover is one
            # exact sweep shared by the batch (index_type='auto' only)
            auto_mode = ann_param(p, "index_type") == "auto"
            high_batch_flat = (
                auto_mode and n_q >= ann_param(p, "auto_batch_flat_q")
                and self._count <= ann_param(p, "auto_batch_flat_rows"))
            if (use_ann and self.config.enable_ann and not ivf_large_k and
                    not high_batch_flat and not low_sel_filter and
                    self._ann is not None and not self._ann_stale and
                    self._count >= min_rows and not self._ann_low_recall):
                tracing.annotate("route", "graph" if self._ann_kind
                                 == "beam_graph" else self._ann_kind)
                try:
                    keys, idx, valid = self._ann_batch_query(
                        arr, k_engine, filter_metadata)
                    return self._answers(arr, keys[:n_q], idx[:n_q],
                                         valid[:n_q], k_engine, k_eff,
                                         filter_metadata, rerank_active)
                except Exception:  # noqa: BLE001 — as the JAX store: exact
                    logger.warning("ANN query failed; falling back to the "
                                   "exact scan", exc_info=True)

            tracing.annotate("route", "flat")
            mask = self._query_mask(filter_metadata, host_mask)
            keys, idx = self._flat_topk(arr, k_engine, mask)
            keys, idx = keys[:n_q], idx[:n_q]
            # NaN keys stay valid, as NEG_INF alone marks an empty slot
            return self._answers(arr, keys, idx, keys != NEG_INF, k_engine,
                                 k_eff, filter_metadata, rerank_active)

    def _answers(self, queries: np.ndarray, keys: np.ndarray,
                 ids: np.ndarray, valid: np.ndarray, k_engine: int,
                 k: int, filter_metadata: dict | None,
                 rerank: bool) -> list:
        """Either route's host (keys, ids, valid) block as the batch's
        answers: formatted as they are, or with ``rerank`` re-scored
        first and formatted at k."""
        if not rerank:
            return self._format_batch(keys, ids, k_engine, valid,
                                      filter_metadata)
        keys, ids, valid = self._rerank_exact(
            queries, ids, self._candidates(ids, valid, k_engine,
                                           filter_metadata), k)
        return self._format_batch(keys, ids, k, valid, None)

    def _candidates(self, ids: np.ndarray, valid: np.ndarray, k: int,
                    filter_metadata: dict | None) -> np.ndarray:
        """(n, w) bool: the entries ``_format_batch`` would answer at k,
        the first k valid ones of a row that pass ``filter_metadata``'s
        exact re-check."""
        if not filter_metadata:
            return valid & (np.cumsum(valid, axis=1) <= k)
        metadata = self._metadata
        keep = np.zeros_like(valid)
        for r, row in enumerate(ids.tolist()):
            taken = 0
            for j in np.flatnonzero(valid[r]).tolist():
                if taken >= k:
                    break
                if metadata_matches(metadata[row[j]], filter_metadata):
                    keep[r, j] = True
                    taken += 1
        return keep

    def _rerank_exact(self, queries: np.ndarray, ids: np.ndarray,
                      keep: np.ndarray, k: int):
        """Re-score the candidates ``keep`` marks in ``ids`` against the
        ORIGINAL f32 host rows and return the exact top k of each row as
        host (keys, ids, valid), keys in the scan's convention (cosine:
        clipped similarity; dot: score; euclidean: minus the squared
        distance, whose root ``_format_batch`` takes, as for a scan).
        The ``store.rerank`` span carries the ``queries`` and the
        ``candidates`` (rows re-scored) of the call.

        The call is scored at once on the store's device: every row's
        candidates, moved to its front in order (the rest padded with row
        0, whose scores are never read), are gathered from the host rows
        into one block (pinned on a card), copied over, scored with
        ``ops/distance.py``'s row reductions, so a candidate's score has
        the same bits in a call of any size, and sorted, ties in
        candidate order."""
        with tracing.span("store.rerank", host_only=True):
            counts = keep.sum(axis=1)
            width = int(counts.max(initial=0))
            tracing.annotate("queries", len(ids))
            tracing.annotate("candidates", int(counts.sum()))
            n, d = len(ids), self.config.dimension
            front = np.argsort(~keep, axis=1, kind="stable")[:, :width]
            cand = np.take_along_axis(ids, front, 1)
            live = np.take_along_axis(keep, front, 1)
            if width == 0:
                return np.zeros((n, 0), np.float32), cand, live
            block = torch.empty((n * width, d), dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")
            # ids are the store's own rows: "clip" skips numpy's bounds
            # pass, which would gather into a temporary first
            np.take(self._host_buf, np.where(live, cand, 0).reshape(-1),
                    axis=0, out=block.numpy(), mode="clip")
            rows = block.to(self.device, non_blocking=True).view(n, width, d)
            q = torch.from_numpy(np.ascontiguousarray(
                queries[:n], dtype=np.float32)).to(self.device)[:, None, :]
            if self.metric == "euclidean":
                exact = -D.row_sqnorms(rows - q)
            elif self.metric == "cosine":
                exact = D.row_dots(D.l2_normalize(rows),
                                   D.l2_normalize(q)).clamp(-1.0, 1.0)
            else:  # dot
                exact = D.row_dots(rows, q)
            exact = exact.masked_fill(
                ~torch.from_numpy(live).to(self.device), NEG_INF)
            top, order = torch.sort(exact, dim=1, descending=True,
                                    stable=True)
            top, order = to_host(top[:, :k], order[:, :k])
            return (top, np.take_along_axis(cand, order, 1),
                    np.take_along_axis(live, order, 1))

    # ------------------------------------------------------------------ ANN

    @property
    def _ann_kind(self) -> str:
        """'beam_graph', 'ivf' or 'flat' (no index: the exact scan serves
        everything). index_type='auto' (the default) resolves from the
        store size, see _auto_pick_kind; the graph is an explicit choice."""
        requested = ann_param(self.config.ann_params, "index_type")
        if requested != "auto":
            return requested
        if self._auto_kind is None:
            self._auto_kind = self._auto_pick_kind()
        return self._auto_kind

    def _auto_pick_kind(self) -> str:
        """Flat below ann_params["auto_flat_rows"], IVF above it; int8/int4
        stores take IVF's gather layout. Large batches re-route to the
        exact scan at query time (batch_query)."""
        flat_rows = ann_param(self.config.ann_params, "auto_flat_rows")
        return "flat" if self._count < flat_rows else "ivf"

    def _make_ann(self) -> IVFIndex | BeamGraphIndex:
        p = self.config.ann_params
        if self._ann_kind == "ivf":
            return IVFIndex(
                dim=self.config.dimension, metric=self.metric,
                **index_args(p, "n_clusters", "nprobe", "bucket_rows",
                             "train_iters", layout="ivf_layout"))
        return BeamGraphIndex(
            dim=self.config.dimension, metric=self.metric,
            device=self.device,
            **index_args(p, "M", "ef_construction", "alpha", "entry_cap",
                         "insert_budget_div", "refine_budget_div"))

    def _ann_search(self, queries_prepared, fetch_k: int):
        """The index's (ids, keys) in the store's final key convention:
        the graph takes ef = max(ef_search, fetch_k), IVF takes nprobe
        (int8's raw x127 scale divided out, as in _flat_topk)."""
        p = self.config.ann_params
        if self._ann_kind == "beam_graph":
            return self._ann.search(
                queries_prepared, self._db, self._count, k=fetch_k,
                ef_search=max(ann_param(p, "ef_search"), fetch_k),
                sqnorms=self._sqnorms)
        ids, keys = self._ann.search(
            queries_prepared, self._db, self._count, k=fetch_k,
            nprobe=p.get("nprobe"), sqnorms=self._sqnorms,
            scales=self._scales)
        if self.config.storage_dtype == "int8":
            keys = np.where(np.isfinite(keys), keys * (1.0 / 127.0), keys)
        return ids, keys

    def _ann_quant_kwargs(self) -> dict:
        """IVF build/add kwargs for int4 storage: the per-row scales drive
        the k-means dequantization (the config refuses a graph on
        quantized rows)."""
        return {"scales": self._scales} if self._quant4 else {}

    def _refresh_ann(self, incremental_from: int | None = None) -> None:
        """Build, or extend from ``incremental_from``, the ANN index over
        the store's own device matrix.

        Runs under _ann_build_lock only (never the store lock): queries
        stay live during a build, routed to the exact scan while
        _ann_stale. Works from a count snapshot; if rows land mid-build,
        staleness is restored so the next refresh covers them."""
        with self._ann_build_lock:
            count = self._count
            if count == 0:
                return
            if ann_param(self.config.ann_params, "index_type") == "auto":
                # a store growing past the crossover promotes to IVF (full
                # build); one shrinking below it demotes to the exact scan
                new_kind = self._auto_pick_kind()
                if new_kind != self._auto_kind:
                    self._auto_kind = new_kind
                    self._ann = None
            if self._ann_kind == "flat":
                self._ann = None
                self._ann_stale = False
                return
            if self._ann is None:
                self._ann = self._make_ann()
            if incremental_from in (None, 0) or \
                    self._ann.size != incremental_from:
                if self._native_graph_build():
                    self._ann.build_cpu(self._host_buf, count)
                else:
                    self._ann.build(self._db, count, sqnorms=self._sqnorms,
                                    **self._ann_quant_kwargs())
            else:
                # incremental adds extend on the device (a graph from
                # either builder)
                self._ann.add(self._db, incremental_from, count,
                              sqnorms=self._sqnorms,
                              **self._ann_quant_kwargs())
            if self.config.persist_mode != "off":
                self._ann.save(self.store_path)
            # re-estimate recall after every full build, and after adds
            # once the store has doubled since the last estimate; before
            # the stale flag clears, so no query sees an index that the
            # remediation is still changing
            if self._ann_checked_at == 0 or \
                    count >= 2 * self._ann_checked_at:
                self._ann_self_check()
            self._ann_stale = False
            if self._count != count:
                self._ann_stale = True

    def _native_graph_build(self) -> bool:
        """Whether a full graph build goes to the native C++ builder:
        ``build_backend`` "cpu" or "auto" and the builder available. The
        JAX values are kept ("tpu" is the store's device); without the
        builder the graph is built on the store's device."""
        if self._ann_kind != "beam_graph":
            return False
        backend = ann_param(self.config.ann_params, "build_backend")
        if backend not in ("cpu", "auto"):
            return False
        if native.available():
            return True
        if backend == "cpu":
            logger.warning("native builder unavailable; building the graph "
                           "on %s", self.device)
        return False

    def _ann_self_check(self, sample: int = 100, k: int = 10) -> None:
        """Sampled recall@k of the index against the exact scan.

        Self-queries a power-of-two sample of stored rows through both
        paths; below ``remediate_target`` IVF doubles nprobe until it
        clears (_remediate_low_recall); below ``recall_warn`` it warns;
        below ``recall_floor`` queries route to the exact scan. The graph
        remediates by full-budget refine passes instead. A hit is an id in
        the exact top-k, or a key that ties the exact k-th within 0.004
        (bf16 ties make the id set an arbitrary tie-break)."""
        p = self.config.ann_params
        if not ann_param(p, "self_check") or self._count < 2 \
                or self._ann is None:
            return
        n = 1 << (min(sample, self._count).bit_length() - 1)
        k_eff = min(k, self._count)
        rng = np.random.default_rng(0)
        rows = np.sort(rng.choice(self._count, size=n, replace=False))
        queries = self._host_buf[rows].astype(np.float32)
        flat_keys, flat_idx = self._flat_topk(queries, k_eff, None)
        kth = np.asarray(flat_keys, np.float32)[:, k_eff - 1]
        tol = 0.004 * np.maximum(1.0, np.abs(kth))
        exact_sets = [{int(x) for x in flat_idx[i]} for i in range(n)]
        prepared = self._prepare_queries(queries)

        def estimate() -> float:
            labels, ann_keys = self._ann_search(prepared, k_eff)
            ann_keys = np.asarray(ann_keys, np.float32)
            hits = 0
            for i in range(n):
                for j in range(k_eff):
                    lab = int(labels[i, j])
                    if lab < 0:
                        continue
                    if lab in exact_sets[i] \
                            or ann_keys[i, j] >= kth[i] - tol[i]:
                        hits += 1
            return hits / float(n * k_eff)

        est = estimate()
        warn = ann_param(p, "recall_warn")
        target = ann_param(p, "remediate_target")
        if est < target and ann_param(p, "auto_remediate"):
            est = self._remediate_low_recall(est, target, estimate)
        self._ann_recall_estimate = est
        self._ann_checked_at = self._count
        floor = ann_param(p, "recall_floor")
        was_low = self._ann_low_recall
        self._ann_low_recall = est < floor
        if self._ann_low_recall:
            logger.warning(
                "ANN sampled recall@%d = %.3f < floor %.2f at %d rows; "
                "routing queries to the exact scan", k_eff, est, floor,
                self._count)
        elif est < warn:
            logger.warning(
                "ANN sampled recall@%d = %.3f below %.2f at %d rows",
                k_eff, est, warn, self._count)
        elif was_low:
            logger.info("ANN sampled recall recovered to %.3f; "
                        "index re-enabled", est)

    def _remediate_low_recall(self, est: float, target: float,
                              estimate) -> float:
        """Raise the index's recall until the estimate clears ``target``
        (re-estimating after each step):

        * IVF recall is probe coverage: double nprobe until nprobe reaches
          ``remediate_nprobe_max`` (default: the built cluster count). The
          new nprobe is written back to ann_params (so it persists in the
          manifest);
        * the beam graph runs full-budget refine passes
          (refine_budget_div = 1) over its graph, at most
          ``remediate_max_refines``.

        The changed index is written to its sidecar."""
        p = self.config.ann_params
        changed = False
        if self._ann_kind == "beam_graph":
            max_refines = int(ann_param(p, "remediate_max_refines"))
            old_div = self._ann.refine_budget_div
            self._ann.refine_budget_div = 1
            try:
                for i in range(max_refines):
                    if est >= target:
                        break
                    self._ann.refine(self._db, sqnorms=self._sqnorms,
                                     passes=1)
                    changed = True
                    est = estimate()
                    logger.warning(
                        "ANN recall remediation: full-budget refine pass "
                        "%d/%d, sampled recall %.3f", i + 1, max_refines,
                        est)
            finally:
                self._ann.refine_budget_div = old_div
        else:
            start = int(p.get("nprobe", self._ann.nprobe))
            cents = self._ann._centroids
            built_clusters = 0 if cents is None else len(cents)
            cap = int(p.get("remediate_nprobe_max",
                            built_clusters or max(256, start * 8)))
            nprobe = start
            while est < target and nprobe < cap:
                nprobe = min(nprobe * 2, cap)
                self._ann.nprobe = nprobe
                p["nprobe"] = nprobe
                changed = True
                est = estimate()
                logger.warning("ANN recall remediation: nprobe %d -> %d, "
                               "sampled recall %.3f", start, nprobe, est)
        if changed and self.config.persist_mode != "off":
            self._ann.save(self.store_path)
        return est

    def _prepare_queries(self, arr: np.ndarray) -> torch.Tensor:
        """Host queries as the index scores them: on the device,
        normalized for cosine, padded to the stored width."""
        q = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q = D.l2_normalize(q)
        return D.pad_dim(q, multiple=self._pad_to)

    def _post_filter_fetch_k(self, k: int, filtered: bool) -> int:
        """ANN fetch size under post-filtering: k*10, scaled up as the
        live fraction f drops (~1/f, capped at 10x the base)."""
        if not (filtered or self._deleted):
            return k
        live_frac = ((self._count - len(self._deleted))
                     / max(self._count, 1))
        return int(min(self._count,
                       math.ceil(k * 10 / max(live_frac, 0.1))))

    def _ann_batch_query(self, arr: np.ndarray, k: int,
                         filter_metadata: dict | None):
        """One index search for the batch: host (keys, ids, valid), the
        tombstones marked invalid; filters are re-checked as the answers
        are formatted."""
        fetch_k = self._post_filter_fetch_k(k, bool(filter_metadata))
        queries = self._prepare_queries(arr)
        with tracing.span("index.search", k=fetch_k):
            labels, keys = self._ann_search(queries, fetch_k)
        valid = labels >= 0
        live = self._live_host_mask()
        if live is not None:   # tombstones post-filter out
            valid &= live[np.where(valid, labels, 0)] > 0
        return keys, labels, valid

    def _load_ann_sidecar(self, n: int) -> None:
        """Open the persisted index when it covers the store's rows, else
        rebuild it."""
        if self._ann_kind == "flat":   # auto below the crossover
            self._ann_stale = False
            return
        self._ann = self._make_ann()
        if self._ann.load(self.store_path) and self._ann.size == n:
            self._ann_stale = False
        else:
            self._refresh_ann()

    # ------------------------------------------------------------- lifecycle

    def optimize(self) -> dict:
        """Compact tombstones, re-pack the device buffers to minimal
        capacity and rebuild the ANN index. Compaction REMAPS row ids (see
        compact())."""
        compacted = 0
        if self._deleted:
            # one index rebuild, below, instead of one in compact too
            compacted = self.compact(rebuild_ann=False,
                                     want_remap=False)["compacted"]
        t0 = time.perf_counter()
        with self._lock, self._rw.write():
            target = self._capacity_for(max(self._count, 1))
            if target != self._cap and self._count:
                self._reset_device(target)
            if self.config.enable_ann and self._count:
                self._refresh_ann()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"optimized": True, "capacity": self._cap,
                "count": self._count, "compacted": compacted,
                "duration_ms": (time.perf_counter() - t0) * 1e3}

    def warmup(self, batch: int = 8, k: int = 10) -> dict:
        """Run the query paths once ahead of traffic: the exact scan at
        both batch shapes and, with an index, one ANN query (on a CUDA
        store the first calls also build the kernels)."""
        with self._lock:
            if self._count == 0:
                return {"warmed": False, "reason": "empty store"}
            t0 = time.perf_counter()
            dummy = np.zeros((batch, self.config.dimension), np.float32)
            dummy[:, 0] = 1.0
            self.batch_query(dummy, k=min(k, self._count), use_ann=False)
            self.batch_query(dummy[:1], k=min(k, self._count),
                             use_ann=False)
            if self.config.enable_ann and self._ann is not None:
                self.batch_query(dummy[:1], k=min(k, self._count))
            return {"warmed": True,
                    "duration_ms": (time.perf_counter() - t0) * 1e3}

    def flush(self) -> None:
        with self._lock:
            if self._dirty and self.config.persist_mode != "off":
                self._save()

    def close(self) -> None:
        self.flush()

    def _metadata_jsonl(self) -> bytes:
        rows, n, buf = self._jsonl
        if rows is not self._metadata:
            rows, n, buf = self._metadata, 0, bytearray()
        buf += persistence.encode_metadata(rows[n:])
        self._jsonl = (rows, len(rows), buf)
        return bytes(buf)

    def _save(self) -> None:
        live = (self._host_buf[: self._count] if self._host_buf is not None
                else np.zeros((0, self.config.dimension), np.float32))
        with self._file_lock:
            persistence.save_store(
                self.store_path, live, self._metadata_jsonl(), self.config)
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
        # the loaded rows become the host buffer, grown in place (realloc)
        # to the store's capacity: a reopen holds them once, not twice. A
        # view (a torn write's committed prefix) is copied first.
        buf = np.require(vectors, np.float32, ("C", "W", "O"))
        buf.resize((self._capacity_for(n), self.config.dimension),
                   refcheck=False)
        self._host_buf, self._host_cap = buf, buf.shape[0]
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
        if self.config.enable_ann:
            self._load_ann_sidecar(n)

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
                "index_type": (self._ann_kind if (self.config.enable_ann
                                                  and self._ann is not None)
                               else "flat"),
                "index_type_requested": ann_param(self.config.ann_params,
                                                  "index_type"),
                "storage_dtype": self.config.storage_dtype,
                "device_capacity": self._cap,
                "ann_recall_estimate": self._ann_recall_estimate,
                "memory_usage_mb": round(device_mb + host_mb, 3),
            }


def create_vector_store(store_path: str | Path,
                        dimension: int = 384, metric: str = "cosine",
                        device: str | torch.device = "cuda",
                        **kwargs) -> TorchVectorStore:
    """Factory with the JAX package's signature plus ``device``."""
    cfg = VectorStoreConfig(dimension=dimension, metric=metric, **kwargs)
    return TorchVectorStore(store_path, cfg, device=device)
