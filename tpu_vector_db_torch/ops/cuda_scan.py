"""Exact flat top-k: the hand-written CUDA scan and its plain version.

Counterpart of ``tpu_vector_db/ops/pallas_scan.py::pallas_flat_topk``,
with the same contract. The kernels are ``csrc/flat_topk.cu``:

* ``scan_kernel``      (k <= 32) replaces ``_scan_kernel``;
* ``scan_kernel_bigk`` (k > 32) replaces ``_scan_kernel_bigk``. The TPU
  kernel stops at k = 1024, where the JAX store turns to its XLA scan;
  this kernel takes any k, so the store serves every k on the card.

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
import threading

import torch

from tpu_vector_db_torch.ops.launches import record
from tpu_vector_db_torch.ops.scan import scan_blocks
from tpu_vector_db_torch.ops.topk import NEG_INF

MAX_K_SMALL = 32      # scan_kernel: per-warp register lists
_MAX_SMEM = 232448    # dynamic shared memory a block may use on sm_90
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.uint8: 3}
# blocks the partial pass aims for: a few per SM on the 132 SMs
_TARGET_BLOCKS = {False: 528, True: 264}
# big-k: a split scans at least 4*k rows, so that a large k does not send
# (nearly) every row of a short split on to the merge
_MIN_ROWS_PER_SPLIT = {False: 1024, True: 4096}
_BIG_ROWS_PER_K = 4

_lib_lock = threading.Lock()
_lib = None


def kernel_name(k: int) -> str:
    return "scan_kernel" if k <= MAX_K_SMALL else "scan_kernel_bigk"


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from tpu_vector_db_torch.ops import _build
            lib = _build.load("flat_topk")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.vdb_flat_topk.argtypes = [
                p, i, i, p, i, i, i, p, p, p, i, i, i, i, i, p, p, p, p, p,
                p, p]
            lib.vdb_flat_topk.restype = i
            lib.vdb_flat_scratch_slots.argtypes = [i, i, i, i]
            lib.vdb_flat_scratch_slots.restype = ctypes.c_longlong
            lib.vdb_scan_smem_bytes.argtypes = [i, i, i, i]
            lib.vdb_scan_smem_bytes.restype = i
            lib.vdb_warps_per_block.argtypes = []
            lib.vdb_warps_per_block.restype = i
            _lib = lib
        return _lib


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
        q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
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
            db_scales):
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
    lib = _library()
    dev = db.device
    q_n = queries.shape[0]
    count = max(0, min(int(count), db.shape[0]))
    euclid = metric == "euclidean"
    big = k > MAX_K_SMALL
    q = queries.to(dev).to(query_dtype(db.dtype)).float().contiguous()
    sq = _f32_on(db_sqnorms, dev, count) if euclid else None
    if euclid and sq is None:
        sq = torch.zeros(max(count, 1), device=dev)  # as the TPU kernel
    mask = _f32_on(filter_mask, dev, count)
    scales = _f32_on(db_scales, dev, count)

    qt = 1
    for cand in (8, 4, 2):
        if cand < 2 * q_n and lib.vdb_scan_smem_bytes(
                cand, d_pad, int(big), k) <= _MAX_SMEM:
            qt = cand
            break
    tiles = -(-q_n // qt)
    min_rows = max(_MIN_ROWS_PER_SPLIT[big], _BIG_ROWS_PER_K * k if big
                   else 0)
    splits = max(1, min(-(-_TARGET_BLOCKS[big] // tiles),
                        -(-count // min_rows)))
    rows_per_split = max(1, -(-count // splits))
    splits = max(1, -(-count // rows_per_split))
    n_lists = splits if big else splits * lib.vdb_warps_per_block()

    cand_keys = torch.empty((q_n, n_lists, k), dtype=torch.float32,
                            device=dev)
    cand_ids = torch.empty((q_n, n_lists, k), dtype=torch.int32, device=dev)
    keys = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    # device-memory scratch for k > 8192 (big-k regions, merge areas)
    slots = lib.vdb_flat_scratch_slots(q_n, qt, splits, k)
    scratch_keys = scratch_ids = None
    if slots:
        scratch_keys = torch.empty(slots, dtype=torch.float32, device=dev)
        scratch_ids = torch.empty(slots, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vdb_flat_topk(
            ptr(q), q_n, d_pad, ptr(db), _DTYPE_CODES[db.dtype], row_bytes,
            count, ptr(sq), ptr(mask), ptr(scales), int(euclid), k, qt,
            splits, rows_per_split, ptr(cand_keys), ptr(cand_ids),
            ptr(keys), ptr(ids), ptr(scratch_keys), ptr(scratch_ids), stream)
    if err != 0:
        raise RuntimeError(f"flat_topk kernel failed: CUDA error {err}")
    record(kernel_name(k))
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
