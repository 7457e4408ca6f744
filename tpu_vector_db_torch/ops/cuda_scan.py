"""Exact flat top-k: the hand-written CUDA scan and its plain version.

Counterpart of ``tpu_vector_db/ops/pallas_scan.py::pallas_flat_topk``,
with the same contract. The kernels are ``csrc/flat_topk.cu``:

* ``scan_kernel``      (k <= 32) replaces ``_scan_kernel``, in one of two
  designs that ``_launch_plan`` picks from the batch and the row type:
  below ``TILE_MIN_Q`` queries a warp scores one row at a time against up
  to 8 queries (``scan_small_k``, bound by bytes); from it a block scores
  tiles of 256 rows against up to 64 queries, f32 by register-tiled FFMA
  and bf16/int8/int4 on the tensor cores (``scan_small_k_tile``). Both
  count as one ``scan_kernel`` launch;
* ``scan_kernel_bigk`` (k > 32) replaces ``_scan_kernel_bigk``, with the
  same two scoring designs picked by the same rule. Up to
  ``MAX_K_LISTS`` the tile keeps its lists in registers as k <= 32 does,
  two entries a lane, and a merge combines the blocks' lists. Otherwise
  each query's keys go to a key scratch in device memory, and a radix
  select takes the exact top-k (``csrc/radix_select.cuh``); past
  ``KEY_SCRATCH_BYTES`` of keys the rows go in chunks whose top-k lists
  a merge combines. The TPU kernel stops at k = 1024, where the JAX
  store turns to its XLA scan; this kernel takes any k, so the store
  serves every k on the card.

``flat_topk`` launches the kernel for a CUDA tensor and uses
``flat_topk_plain`` only for a tensor on the CPU. Each launch adds one to
that kernel's count in ``LAUNCHES`` (``ops/launches.py``).

Keys are in the maximize convention of ops/distance.py: cosine/dot the
score, euclidean ``-(||q - x||^2)``. Order is key descending, then id
ascending. Slots past the live rows hold key -inf and id 0.

Query precision follows the TPU kernel: queries are rounded to the
storage dtype (bf16 for bf16, int8 and int4 rows) before scoring, and
every product accumulates in float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops._build import CSRC, Library
from tpu_vector_db_torch.ops.distance import row_sqnorms
from tpu_vector_db_torch.ops.launches import record
from tpu_vector_db_torch.ops.scan import scan_blocks
from tpu_vector_db_torch.ops.topk import MERGE_SMALL_MAX_K, NEG_INF

MAX_K_SMALL = MERGE_SMALL_MAX_K  # scan_kernel: per-warp register lists
# scan_kernel_bigk on the tile design up to this k: the same lists with two
# entries a lane, no key scratch (csrc/flat_topk.cu MAX_K_LISTS)
MAX_K_LISTS = 64
# the tile design from this batch up, by row type (chip_smoke.py's
# crossover lines time both designs at batch 2-16). f32: up to batch 8 the
# row loop reads the rows once and is bound by bytes, as the tile is by
# its CUDA-core operations; from batch 9 the loop reads them twice. The
# tensor-core tile is faster than the loop from batch 2. k > 32 scores by
# the same rule.
TILE_MIN_Q = {torch.float32: 9, torch.bfloat16: 2, torch.int8: 2,
              torch.uint8: 2}
# k > 32: most bytes of the (Q, rows) f32 key scratch one launch writes;
# past it the rows are scored and selected in chunks
KEY_SCRATCH_BYTES = 512 << 20
_MAX_SMEM = 232448    # dynamic shared memory a block may use on sm_90
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.uint8: 3}
# row loop (scan_small_k): blocks the launch aims for, a few per SM on the
# 132 SMs, and the least rows of a split
_TARGET_BLOCKS = 528
_MIN_ROWS_PER_SPLIT = 1024
_WARPS = 8            # warps of a scan block (csrc/topk_common.cuh)
# tile design (csrc/flat_topk.cu): rows per tile, query tiles per type;
# one block per SM (its shared memory), so a launch aims at one per SM
_TILE_ROWS = 256
_TILE_QT = {torch.float32: (16, 32, 64)}
_TILE_QT_MMA = (64,)
# stored components of one pipeline stage: the tile needs d_pad to be a
# multiple (the stores pad to 128, int4 to 256)
_TILE_COMPS = {torch.float32: 32}
_TILE_COMPS_MMA = 64


class LaunchPlan(NamedTuple):
    """How ``flat_topk`` launches: scoring ``design`` "loop"
    (scan_small_k) or "tile" (scan_small_k_tile), queries per block
    ``qt``, ``splits`` row ranges of ``rows_per_split`` rows, and the
    candidate lists per query the merge combines (``n_lists``). k > 32
    through the key scratch: rows are scored and selected ``chunk_rows``
    at a time (a key scratch of Q x chunk_rows f32), one list per chunk;
    0 where the scan keeps lists (k <= 32, and the tile up to
    MAX_K_LISTS)."""
    design: str
    qt: int
    splits: int
    rows_per_split: int
    n_lists: int
    chunk_rows: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _loop_smem_bytes(qt: int, d_pad: int, store: bool) -> int:
    """Shared memory of scan_small_k (csrc/flat_topk.cu ``launch_loop``):
    the queries, 8 * sum(q), and with ``store`` a tile's keys."""
    return qt * d_pad * 4 + 32 + (qt * (_TILE_ROWS + 4) * 4 if store else 0)


def _chunk_rows(q_n: int, count: int, budget: int) -> int:
    """k > 32: rows a launch scores, whole row tiles, so that the key
    scratch (q_n x rows f32) stays within ``budget`` bytes."""
    fit = max(1, budget // (4 * q_n) // _TILE_ROWS) * _TILE_ROWS
    return min(fit, _cdiv(max(count, 1), _TILE_ROWS) * _TILE_ROWS)


def _launch_plan(q_n: int, db_dtype: torch.dtype, d_pad: int, k: int,
                 count: int, n_sm: int = 132,
                 budget: int = KEY_SCRATCH_BYTES) -> LaunchPlan:
    """The scoring design and launch shape for a call: the tile from
    TILE_MIN_Q queries of the row type (d_pad a multiple of its stage),
    else the row loop; past MAX_K_SMALL (on the tile, past MAX_K_LISTS)
    the keys go to the radix select, in chunks that keep the key scratch
    within ``budget`` bytes."""
    if q_n >= TILE_MIN_Q[db_dtype] and d_pad % _TILE_COMPS.get(
            db_dtype, _TILE_COMPS_MMA) == 0:
        design = "tile"
    else:
        design = "loop"
    return _plan(design, q_n, db_dtype, d_pad, k, count, n_sm, budget)


def _plan(design: str, q_n: int, db_dtype: torch.dtype, d_pad: int, k: int,
          count: int, n_sm: int = 132,
          budget: int = KEY_SCRATCH_BYTES) -> LaunchPlan:
    """The launch shape of one scoring design (``_launch_plan`` picks the
    design; chip_smoke.py's crossover lines time both at the same
    batch)."""
    count = max(0, count)
    lists = k <= (MAX_K_LISTS if design == "tile" else MAX_K_SMALL)
    chunk = 0 if lists else _chunk_rows(q_n, count, budget)
    rows = min(count, chunk) if chunk else count  # rows of one launch
    n_chunks = max(1, _cdiv(count, chunk)) if chunk else 0
    if design == "tile":
        sizes = _TILE_QT.get(db_dtype, _TILE_QT_MMA)
        qt = next((c for c in sizes if c >= q_n), sizes[-1])
        tiles = _cdiv(q_n, qt)
        splits = max(1, min(_cdiv(n_sm, tiles), _cdiv(rows, _TILE_ROWS)))
        rows_per_split = _cdiv(max(1, _cdiv(rows, splits)),
                               _TILE_ROWS) * _TILE_ROWS
        splits = max(1, _cdiv(rows, rows_per_split))
        return LaunchPlan(design, qt, splits, rows_per_split,
                          n_chunks or splits, chunk)
    qt = 1
    for cand in (8, 4, 2):
        if cand < 2 * q_n and _loop_smem_bytes(cand, d_pad, bool(chunk)) \
                <= _MAX_SMEM:
            qt = cand
            break
    tiles = _cdiv(q_n, qt)
    splits = max(1, min(_cdiv(_TARGET_BLOCKS, tiles),
                        _cdiv(rows, _MIN_ROWS_PER_SPLIT)))
    rows_per_split = max(1, _cdiv(rows, splits))
    if chunk:   # whole row tiles: the keys go out in 16-byte runs
        rows_per_split = _cdiv(rows_per_split, _TILE_ROWS) * _TILE_ROWS
    splits = max(1, _cdiv(rows, rows_per_split))
    return LaunchPlan(design, qt, splits, rows_per_split,
                      n_chunks or splits * _WARPS, chunk)


def kernel_name(k: int) -> str:
    return "scan_kernel" if k <= MAX_K_SMALL else "scan_kernel_bigk"


def _signatures(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vdb_flat_topk.argtypes = [
        p, p, i, i, p, i, i, i, p, p, p, i, i, i, i, i, i, i, i, p,
        p, p, p, p, p]
    lib.vdb_flat_topk.restype = i
    lib.vdb_flat_scratch_bytes.argtypes = [i, i, i, i]
    lib.vdb_flat_scratch_bytes.restype = ctypes.c_longlong


LIBRARY = Library(CSRC / "flat_topk.cu", _signatures)


def query_dtype(db_dtype: torch.dtype) -> torch.dtype:
    """The precision queries are rounded to before scoring: bf16 for
    bf16/int8/int4 rows, f32 for f32 rows."""
    return torch.float32 if db_dtype == torch.float32 else torch.bfloat16


def _check(queries, db, k, db_scales) -> int:
    """Validate the contract; returns d_pad (unpacked width)."""
    if k < 1:
        raise ValueError(f"flat_topk needs k >= 1, got {k}")
    if db.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported db dtype {db.dtype}")
    quant4 = db.dtype == torch.uint8
    d_pad = db.shape[1] * 2 if quant4 else db.shape[1]
    if quant4 and d_pad % 256:
        raise ValueError(f"int4 mode needs d_pad % 256 == 0, got {d_pad}")
    if quant4 and db_scales is None:
        raise ValueError("uint8-packed int4 db needs db_scales")
    if db_scales is not None and not quant4:
        raise ValueError("db_scales is only meaningful for uint8-packed "
                         "int4 databases")
    if queries.ndim != 2 or queries.shape[1] != d_pad:
        raise ValueError(
            f"queries must be (Q, {d_pad}), got {tuple(queries.shape)}")
    return d_pad


def _finish(keys, ids, queries, metric):
    """Euclidean: subtract ||q||^2 from the finite keys only."""
    if metric == "euclidean":
        q_sq = row_sqnorms(queries)[:, None]
        keys = torch.where(keys > NEG_INF, keys - q_sq, keys)
    return keys, ids


def flat_topk(queries, db, count, k: int, metric: str = "cosine",
              db_sqnorms=None, filter_mask=None, db_scales=None):
    """Exact top-k over prepared (cosine: unit-norm) db rows.

    queries (Q, d_pad) f32; db (N, d_pad) f32/bf16/int8 or int4 packed
    (N, d_pad/2) uint8 with db_scales (N,) f32; db_sqnorms (N,) f32 for
    euclidean; filter_mask (N,) (rows with mask <= 0.5 are dropped);
    rows with id >= count are dropped. Returns (keys (Q,k) f32,
    ids (Q,k) i32)."""
    d_pad = _check(queries, db, k, db_scales)
    if db.device.type == "cpu":
        return flat_topk_plain(queries, db, count, k, metric, db_sqnorms,
                               filter_mask, db_scales)
    if db.device.type != "cuda":
        raise ValueError(f"flat_topk runs on cuda or cpu, got {db.device}")
    keys, ids = _launch(queries, db, d_pad, count, k, metric, db_sqnorms,
                        filter_mask, db_scales)
    return _finish(keys, ids, queries, metric)


def _f32_on(t, device, n):
    if t is None:
        return None
    if t.shape[0] < n:
        raise ValueError(f"per-row input has {t.shape[0]} rows, need {n}")
    return t.to(device=device, dtype=torch.float32).contiguous()


def _launch(queries, db, d_pad, count, k, metric, db_sqnorms, filter_mask,
            db_scales, plan: LaunchPlan | None = None):
    """One call of the kernel on db's card (scan + merge where the scan
    keeps lists, else scan + select per chunk, and a merge of several
    chunks), shaped by ``plan`` (``_launch_plan``'s when None)."""
    if torch.cuda.get_device_capability(db.device) != (9, 0):
        raise RuntimeError(
            "csrc/flat_topk.cu is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(db.device)} is not")
    if not db.is_contiguous():
        raise ValueError("db must be contiguous")
    row_bytes = db.shape[1] * db.element_size()
    if row_bytes % 16 or db.data_ptr() % 16:
        # the kernel reads every row in 16-byte loads
        raise ValueError("db rows must be a multiple of 16 bytes and start "
                         "16-byte aligned")
    lib = LIBRARY.load()
    dev = db.device
    q_n = queries.shape[0]
    count = max(0, min(int(count), db.shape[0]))
    euclid = metric == "euclidean"
    if plan is None:
        plan = _launch_plan(
            q_n, db.dtype, d_pad, k, count,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    rounded = queries.to(dev).to(query_dtype(db.dtype)).contiguous()
    q = rounded.float().contiguous()
    # the tensor-core tile reads the bf16 queries themselves
    q16 = rounded if rounded.dtype == torch.bfloat16 \
        and plan.design == "tile" else None
    sq = _f32_on(db_sqnorms, dev, count) if euclid else None
    if euclid and sq is None:
        sq = torch.zeros(max(count, 1), device=dev)  # as the TPU kernel
    mask = _f32_on(filter_mask, dev, count)
    scales = _f32_on(db_scales, dev, count)

    # lists: the splits'; key scratch: the chunks', when several
    cand_keys = cand_ids = None
    if plan.chunk_rows == 0 or plan.n_lists > 1:
        cand_keys = torch.empty((q_n, plan.n_lists, k), dtype=torch.float32,
                                device=dev)
        cand_ids = torch.empty((q_n, plan.n_lists, k), dtype=torch.int32,
                               device=dev)
    keys = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    # key scratch, histograms, survivors (and merge areas); none for lists
    n_bytes = lib.vdb_flat_scratch_bytes(q_n, k, count, plan.chunk_rows)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=dev) \
        if n_bytes else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vdb_flat_topk(
            ptr(q), ptr(q16), q_n, d_pad, ptr(db), _DTYPE_CODES[db.dtype],
            row_bytes, count, ptr(sq), ptr(mask), ptr(scales), int(euclid),
            k, plan.qt, int(plan.design == "tile"), plan.splits,
            plan.rows_per_split, plan.n_lists, plan.chunk_rows,
            ptr(cand_keys), ptr(cand_ids), ptr(keys), ptr(ids),
            ptr(scratch), stream)
    if err != 0:
        raise RuntimeError(f"flat_topk kernel failed: CUDA error {err}")
    record(kernel_name(k))
    if k > MAX_K_SMALL:
        # on the caller's span (``store.scan``): how the launch selected
        tracing.annotate("select", "radix" if plan.chunk_rows else "lists")
    if plan.chunk_rows:
        # k > 32: the row chunks whose lists the merge combined (1: one
        # launch scored every row)
        tracing.annotate("chunks", plan.n_lists)
    return keys, ids


def flat_topk_plain(queries, db, count, k: int, metric: str = "cosine",
                    db_sqnorms=None, filter_mask=None, db_scales=None,
                    block_rows: int = 32768):
    """``flat_topk`` in plain torch on ``ops/scan.py::scan_blocks``, so
    no (Q, N) score matrix is built. Runs on any device; on a CUDA device
    the caller keeps ``torch.backends.cuda.matmul.allow_tf32`` False
    (its default) for f32-exact products."""
    _check(queries, db, k, db_scales)
    quant4 = db.dtype == torch.uint8
    dev = db.device
    count = max(0, min(int(count), db.shape[0]))
    q = queries.to(dev).to(query_dtype(db.dtype)).float()
    qsum8 = 8.0 * q.sum(dim=1) if quant4 else None

    def block_keys(start: int, stop: int) -> torch.Tensor:
        rows = db[start:stop]
        if quant4:
            u = rows.to(torch.int32)
            nib = torch.cat([u & 15, u >> 4], dim=1).float()
            keys = (q @ nib.T - qsum8[:, None]) \
                * db_scales[start:stop].float()[None, :]
        else:
            keys = q @ rows.float().T
        if metric == "euclidean":
            sq = (db_sqnorms[start:stop].float() if db_sqnorms is not None
                  else torch.zeros(stop - start, device=dev))
            keys = 2.0 * keys - sq[None, :]
        return keys

    live = (None if filter_mask is None
            else filter_mask[:count].to(dev).float() > 0.5)
    best_vals, best_idx = scan_blocks(block_keys, count, q.shape[0], k, dev,
                                      live, block_rows)
    best_idx = torch.where(best_vals > NEG_INF, best_idx,
                           torch.zeros_like(best_idx))
    return _finish(best_vals, best_idx, queries, metric)
