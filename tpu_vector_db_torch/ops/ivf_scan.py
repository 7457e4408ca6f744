"""IVF probe scans: the hand-written CUDA kernel and the plain torch probes.

Counterpart of ``tpu_vector_db/ops/ivf_scan.py``. The index
(``index/ivf.py``) lays the rows out cluster-major in fixed-size buckets
(NB, Bc, d_pad); a query probes the ``nprobe`` buckets ``sel[q, :]`` that
its centroid scores chose.

* ``ivf_probe_topk`` wraps the kernel ``ivf_kernel`` (``csrc/ivf_topk.cu``),
  which replaces the TPU kernel ``_ivf_kernel`` behind
  ``ivf_probe_topk_pallas``: cosine, dot and euclidean keys over f32 or
  bf16 buckets, k <= 32. It launches the kernel for a CUDA tensor and
  uses ``ivf_probe_topk_plain`` only for a tensor on the CPU. Each launch
  adds one to ``LAUNCHES["ivf_kernel"]`` (``ops/launches.py``).
* ``ivf_probe_topk_plain`` is the counterpart of ``ivf_probe_topk_xla``
  (any k, any metric, any device) and the kernel's plain version.
* ``ivf_probe_topk_gather`` is the counterpart of
  ``ivf_probe_topk_gather``: probes gather their rows from the store's
  flat int8/int4/bf16 matrix, with no bucketized copy. It is the plain
  version of ``ivf_gather_topk``, which launches the kernel
  ``ivf_gather_kernel`` (``vdb_ivf_gather_topk`` in ``csrc/ivf_topk.cu``)
  for bf16, int8 or int4 rows on a CUDA tensor, cosine/dot, k <= 64
  (``MAX_GATHER_KERNEL_K``), and adds one to
  ``LAUNCHES["ivf_gather_kernel"]`` a launch; it uses the plain probe
  only for a tensor on the CPU.
* ``merge_small_k`` runs the k <= 32 merge of both scans' candidate lists
  (``merge_small_k`` in ``csrc/topk_common.cuh``, the second launch of
  ``ivf_kernel`` and of the flat ``scan_kernel``) alone: the sharded
  paths' k·P merge (``parallel/sharded_scan.py``). Each launch adds one to
  ``LAUNCHES["merge_small_k"]``. ``merge_small_k_plain`` is its plain
  version.

Keys are in the maximize convention of ops/distance.py. Order is key
descending, then global row id ascending, so a full probe returns what the
flat scan returns. Empty slots hold key -inf and id -1. Queries are rounded
to the bucket type (bf16 for int8/int4 rows) and every product
accumulates in float32.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_vector_db_torch.ops._build import CSRC, Library
from tpu_vector_db_torch.ops.distance import row_sqnorms
from tpu_vector_db_torch.ops.launches import record
from tpu_vector_db_torch.ops.topk import (MERGE_SMALL_MAX_K, NEG_INF,
                                          merge_topk, sort_by_key_then_id)

MAX_IVF_KERNEL_K = MERGE_SMALL_MAX_K
# the gather kernel's largest k: two list entries a lane
MAX_GATHER_KERNEL_K = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GATHER_CODES = {torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
# blocks the kernel aims for (about 8 per SM on the 132 SMs), and the
# fewest bucket rows one block scans
_TARGET_BLOCKS = 1056
_MIN_ROWS_PER_SPLIT = 64


def _signatures(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vdb_ivf_topk.argtypes = [
        p, i, i, p, i, i, i, p, i, p, p, p, i, i, i, p, p, p, p, p]
    lib.vdb_ivf_topk.restype = i
    lib.vdb_merge_small_k.argtypes = [p, p, i, i, i, p, p, i, p]
    lib.vdb_merge_small_k.restype = i
    lib.vdb_ivf_gather_topk.argtypes = [
        p, i, i, p, i, p, i, i, p, i, p, p, i, i, p, p, p, p, p]
    lib.vdb_ivf_gather_topk.restype = i


LIBRARY = Library(CSRC / "ivf_topk.cu", _signatures)


def _finish_euclidean(vals, idx, queries, metric):
    """Euclidean: subtract ||q||^2 from the finite keys only."""
    if metric == "euclidean":
        q_sq = row_sqnorms(queries)[:, None]
        vals = torch.where(vals > NEG_INF, vals - q_sq, vals)
    return vals, idx


def _pad_k(vals, idx, k):
    """Pad (Q, k_eff) results to (Q, k) with -inf / -1."""
    q_n, k_eff = vals.shape
    if k_eff < k:
        vals = torch.cat([vals, torch.full((q_n, k - k_eff), NEG_INF,
                                           device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.full((q_n, k - k_eff), -1,
                                         dtype=torch.int32,
                                         device=idx.device)], dim=1)
    return vals, torch.where(vals > NEG_INF, idx, torch.full_like(idx, -1))


def _probe_loop(q_n, n_probe, k_eff, device, probe_scores):
    """Running top-k over the probes: ``probe_scores(p)`` gives the
    (Q, Bc) keys and global ids of probe p (-inf where not live)."""
    best_vals = torch.full((q_n, k_eff), NEG_INF, device=device)
    best_idx = torch.full((q_n, k_eff), -1, dtype=torch.int32, device=device)
    for p in range(n_probe):
        scores, gids = probe_scores(p)
        best_vals, best_idx = merge_topk(best_vals, best_idx, scores, gids,
                                         k_eff)
    return best_vals, best_idx


def ivf_probe_topk_plain(queries, db_buckets, bucket_ids, sel, k: int,
                         metric: str = "cosine", bucket_sqnorms=None,
                         bucket_fills=None):
    """Probe scan in plain torch, one probe at a time: gather the probed
    buckets, score them, merge into a running top-k.

    queries (Q, d_pad) prepared like the bucket rows; db_buckets (NB, Bc,
    d_pad) f32/bf16; bucket_ids (NB, Bc) i32 (-1 = empty slot); sel (Q,
    nprobe) i32; bucket_sqnorms (NB, Bc) f32 for euclidean; bucket_fills
    (NB,) i32, when given, also drops slots at or past the fill count (the
    kernel's rule). Returns (keys (Q, k) f32, ids (Q, k) i32)."""
    q_n = queries.shape[0]
    bc = bucket_ids.shape[1]
    n_probe = sel.shape[1]
    dev = db_buckets.device
    k_eff = min(k, n_probe * bc)
    q = queries.to(dev).to(db_buckets.dtype).float()
    sel = sel.to(dev).long()
    bucket_ids = bucket_ids.to(dev)
    slot = torch.arange(bc, device=dev)

    def probe_scores(p):
        b = sel[:, p]
        gids = bucket_ids[b]                                   # (Q, Bc)
        cross = torch.bmm(db_buckets[b].float(), q[:, :, None])[:, :, 0]
        scores = (2.0 * cross - bucket_sqnorms.to(dev)[b].float()
                  if metric == "euclidean" else cross)
        live = gids >= 0
        if bucket_fills is not None:
            live &= slot[None, :] < bucket_fills.to(dev)[b][:, None]
        return torch.where(live, scores, torch.full_like(scores, NEG_INF)), \
            gids

    vals, idx = _probe_loop(q_n, n_probe, k_eff, dev, probe_scores)
    vals, idx = _pad_k(vals, idx, k)
    return _finish_euclidean(vals, idx, queries, metric)


def ivf_probe_topk_gather(queries, db_flat, bucket_ids, sel, k: int,
                          metric: str = "cosine", db_scales=None):
    """Probe scan that gathers the probed rows from the store's flat
    matrix (N_pad, d) bf16/int8 or (N_pad, d/2) uint8-packed int4 with
    db_scales: the index keeps only its (NB, Bc) id table. int8 keys come
    back in the raw x127 quantizer scale; the caller divides. Cosine/dot
    only (the quantized capacity modes are cosine by config)."""
    if metric == "euclidean":
        raise ValueError("gather-layout probes are cosine/dot only "
                         "(quantized capacity modes are cosine by config)")
    q_n = queries.shape[0]
    bc = bucket_ids.shape[1]
    n_probe = sel.shape[1]
    dev = db_flat.device
    k_eff = min(k, n_probe * bc)
    quant4 = db_flat.dtype == torch.uint8
    if quant4 and db_scales is None:
        raise ValueError("uint8-packed int4 db needs db_scales")
    q = queries.to(dev).to(torch.bfloat16 if db_flat.element_size() == 1
                           else db_flat.dtype).float()
    sel = sel.to(dev).long()
    bucket_ids = bucket_ids.to(dev)

    def probe_scores(p):
        gids = bucket_ids[sel[:, p]]                           # (Q, Bc)
        safe = torch.clamp(gids, min=0).long()
        rows = db_flat[safe]                                   # (Q, Bc, cols)
        if quant4:
            u = rows.to(torch.int32)
            half = u.shape[-1]
            lo = ((u & 15) - 8).float()
            hi = ((u >> 4) - 8).float()
            cross = (torch.bmm(lo, q[:, :half, None])
                     + torch.bmm(hi, q[:, half:, None]))[:, :, 0]
            scores = cross * db_scales[safe].float()
        else:
            scores = torch.bmm(rows.float(), q[:, :, None])[:, :, 0]
        return torch.where(gids >= 0, scores,
                           torch.full_like(scores, NEG_INF)), gids

    vals, idx = _probe_loop(q_n, n_probe, k_eff, dev, probe_scores)
    return _pad_k(vals, idx, k)


def ivf_gather_topk(queries, db_flat, bucket_ids, bucket_fills, sel,
                    k: int, metric: str = "cosine", db_scales=None):
    """Probe scan of the gather layout, cosine/dot, k <= 64 on the card:
    the kernel ``ivf_gather_kernel`` for a CUDA tensor,
    ``ivf_probe_topk_gather`` (its plain version, any k) for a CPU
    tensor. Arguments as ``ivf_probe_topk_gather``'s, with bucket_fills
    (NB,) i32, the live slots of each bucket (its ids past the fill are
    -1). Returns (keys (Q, k) f32, global ids (Q, k) i32, -1 in empty
    slots); int8 keys in the raw x127 scale."""
    if metric == "euclidean":
        raise ValueError("gather-layout probes are cosine/dot only "
                         "(quantized capacity modes are cosine by config)")
    if db_flat.device.type == "cpu":
        return ivf_probe_topk_gather(queries, db_flat, bucket_ids, sel, k,
                                     metric=metric, db_scales=db_scales)
    if db_flat.device.type != "cuda":
        raise ValueError(
            f"ivf_gather_topk runs on cuda or cpu, got {db_flat.device}")
    if not 1 <= k <= MAX_GATHER_KERNEL_K:
        raise ValueError(f"the gather probe kernel supports 1 <= k <= "
                         f"{MAX_GATHER_KERNEL_K}, got {k}")
    if db_flat.dtype not in _GATHER_CODES:
        raise ValueError(f"the gather probe kernel takes bf16, int8 or "
                         f"uint8-packed int4 rows, got {db_flat.dtype}")
    if db_flat.dtype == torch.uint8 and db_scales is None:
        raise ValueError("uint8-packed int4 db needs db_scales")
    nb, bc = bucket_ids.shape
    d_pad = db_flat.shape[1] * (2 if db_flat.dtype == torch.uint8 else 1)
    if queries.ndim != 2 or queries.shape[1] != d_pad:
        raise ValueError(
            f"queries must be (Q, {d_pad}), got {tuple(queries.shape)}")
    if sel.ndim != 2 or sel.shape[0] != queries.shape[0] \
            or bucket_fills.shape[0] != nb:
        raise ValueError("sel must be (Q, nprobe) and bucket_fills (NB,)")
    if not db_flat.is_contiguous() or db_flat.data_ptr() % 16:
        raise ValueError("db_flat must be contiguous and 16-byte aligned")
    dev = db_flat.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            "csrc/ivf_topk.cu is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(dev)} is not")
    return _gather_launch(queries, db_flat, bucket_ids, bucket_fills, sel, k,
                          db_scales)


def _gather_launch(queries, db_flat, bucket_ids, bucket_fills, sel, k: int,
                   db_scales=None):
    """One launch of ``vdb_ivf_gather_topk`` (the probe, then its merge)
    over checked arguments: each (query, probe) bucket split in slices of
    at least ``_MIN_ROWS_PER_SPLIT`` slots, so that about
    ``_TARGET_BLOCKS`` blocks fill the card."""
    lib = LIBRARY.load()
    dev = db_flat.device
    nb, bc = bucket_ids.shape
    q_n, n_probe = sel.shape
    # queries rounded to bf16, as the plain probe rounds them
    q = queries.to(dev).to(torch.bfloat16).float().contiguous()
    ids = bucket_ids.to(device=dev, dtype=torch.int32).contiguous()
    fills = bucket_fills.to(device=dev, dtype=torch.int32).contiguous()
    sel = sel.to(device=dev, dtype=torch.int32).contiguous()
    scales = (db_scales.to(device=dev, dtype=torch.float32).contiguous()
              if db_flat.dtype == torch.uint8 else None)
    splits = max(1, min(-(-_TARGET_BLOCKS // (q_n * n_probe)),
                        bc // _MIN_ROWS_PER_SPLIT))
    cand_keys = torch.empty((q_n, n_probe * splits, k), dtype=torch.float32,
                            device=dev)
    cand_ids = torch.empty((q_n, n_probe * splits, k), dtype=torch.int32,
                           device=dev)
    keys = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vdb_ivf_gather_topk(
            q.data_ptr(), q_n, q.shape[1], db_flat.data_ptr(),
            _GATHER_CODES[db_flat.dtype],
            None if scales is None else scales.data_ptr(), nb, bc,
            sel.data_ptr(), n_probe, fills.data_ptr(), ids.data_ptr(), k,
            splits, cand_keys.data_ptr(), cand_ids.data_ptr(),
            keys.data_ptr(), out_ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ivf_gather_topk kernel failed: CUDA error {err}")
    record("ivf_gather_kernel")
    return keys, out_ids


def _check(queries, db_buckets, bucket_ids, bucket_fills, sel, k, metric,
           bucket_sqnorms):
    if not 1 <= k <= MAX_IVF_KERNEL_K:
        raise ValueError(f"the IVF probe kernel supports 1 <= k <= "
                         f"{MAX_IVF_KERNEL_K}, got {k}")
    if db_buckets.dtype not in _DTYPE_CODES:
        raise ValueError(f"the IVF probe kernel takes f32 or bf16 buckets, "
                         f"got {db_buckets.dtype}")
    nb, bc, d_pad = db_buckets.shape
    if tuple(bucket_ids.shape) != (nb, bc) or bucket_fills.shape[0] != nb:
        raise ValueError("bucket_ids must be (NB, Bc) and bucket_fills "
                         "(NB,) for buckets (NB, Bc, d_pad)")
    if queries.ndim != 2 or queries.shape[1] != d_pad:
        raise ValueError(
            f"queries must be (Q, {d_pad}), got {tuple(queries.shape)}")
    if sel.ndim != 2 or sel.shape[0] != queries.shape[0]:
        raise ValueError("sel must be (Q, nprobe)")
    if metric == "euclidean" and bucket_sqnorms is None:
        raise ValueError("euclidean probes need bucket_sqnorms")


def ivf_probe_topk(queries, db_buckets, bucket_ids, bucket_fills, sel,
                   k: int, metric: str = "cosine", bucket_sqnorms=None):
    """Probe scan of the bucketized layout, k <= 32: the CUDA kernel on a
    CUDA tensor, ``ivf_probe_topk_plain`` on a CPU tensor. Returns (keys
    (Q, k) f32, global ids (Q, k) i32, -1 in empty slots)."""
    _check(queries, db_buckets, bucket_ids, bucket_fills, sel, k, metric,
           bucket_sqnorms)
    if db_buckets.device.type == "cpu":
        return ivf_probe_topk_plain(queries, db_buckets, bucket_ids, sel, k,
                                    metric, bucket_sqnorms, bucket_fills)
    if db_buckets.device.type != "cuda":
        raise ValueError(
            f"ivf_probe_topk runs on cuda or cpu, got {db_buckets.device}")
    keys, ids = _launch(queries, db_buckets, bucket_ids, bucket_fills, sel,
                        k, metric, bucket_sqnorms)
    return _finish_euclidean(keys, ids, queries, metric)


def _launch(queries, db_buckets, bucket_ids, bucket_fills, sel, k, metric,
            bucket_sqnorms):
    dev = db_buckets.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            "csrc/ivf_topk.cu is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(dev)} is not")
    if not db_buckets.is_contiguous() or db_buckets.data_ptr() % 16:
        raise ValueError("db_buckets must be contiguous and 16-byte aligned")
    lib = LIBRARY.load()
    nb, bc, d_pad = db_buckets.shape
    q_n, n_probe = sel.shape
    euclid = metric == "euclidean"
    q = queries.to(dev).to(db_buckets.dtype).float().contiguous()
    ids = bucket_ids.to(device=dev, dtype=torch.int32).contiguous()
    fills = bucket_fills.to(device=dev, dtype=torch.int32).contiguous()
    sel = sel.to(device=dev, dtype=torch.int32).contiguous()
    sq = (bucket_sqnorms.to(device=dev, dtype=torch.float32).contiguous()
          if euclid else None)
    # split each bucket so that even a batch-1 query fills the card
    splits = max(1, min(-(-_TARGET_BLOCKS // (q_n * n_probe)),
                        bc // _MIN_ROWS_PER_SPLIT))
    cand_keys = torch.empty((q_n, n_probe * splits, k), dtype=torch.float32,
                            device=dev)
    cand_ids = torch.empty((q_n, n_probe * splits, k), dtype=torch.int32,
                           device=dev)
    keys = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vdb_ivf_topk(
            ptr(q), q_n, d_pad, ptr(db_buckets),
            _DTYPE_CODES[db_buckets.dtype], nb, bc, ptr(sel), n_probe,
            ptr(fills), ptr(ids), ptr(sq), int(euclid), k, splits,
            ptr(cand_keys), ptr(cand_ids), ptr(keys), ptr(out_ids), stream)
    if err != 0:
        raise RuntimeError(f"ivf_topk kernel failed: CUDA error {err}")
    record("ivf_kernel")
    return keys, out_ids


def merge_small_k_plain(keys, ids, k: int, empty_id: int = -1):
    """The merge's plain version: each query's (key, id) candidates sorted
    by key descending, then id ascending, and cut to k. keys (Q, n) f32,
    ids (Q, n) i32. Returns (keys (Q, k), ids (Q, k)): -inf past the live
    candidates, and ids ``empty_id`` wherever the key is -inf."""
    vals, idx = sort_by_key_then_id(keys.float(), ids.to(torch.int32))
    vals, idx = _pad_k(vals[:, :k], idx[:, :k], k)
    return vals, torch.where(vals > NEG_INF, idx,
                             torch.full_like(idx, empty_id))


def merge_small_k(keys, ids, k: int, empty_id: int = -1):
    """The k <= 32 merge alone: the CUDA kernel on a CUDA tensor,
    ``merge_small_k_plain`` on a CPU tensor. Candidate ids must be
    distinct within a query among the finite keys (-inf candidates are
    never read), as the scans write them."""
    if not 1 <= k <= MERGE_SMALL_MAX_K:
        raise ValueError(f"merge_small_k takes 1 <= k <= "
                         f"{MERGE_SMALL_MAX_K}, got {k}")
    if keys.ndim != 2 or tuple(ids.shape) != tuple(keys.shape) \
            or keys.shape[0] < 1 or keys.shape[1] < 1:
        raise ValueError("keys and ids must be the same (Q, n) shape, "
                         "Q, n >= 1")
    if keys.device.type == "cpu":
        return merge_small_k_plain(keys, ids, k, empty_id)
    if keys.device.type != "cuda":
        raise ValueError(f"merge_small_k runs on cuda or cpu, got "
                         f"{keys.device}")
    dev = keys.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            "csrc/ivf_topk.cu is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(dev)} is not")
    lib = LIBRARY.load()
    q_n, n = keys.shape
    keys = keys.to(torch.float32).contiguous()
    ids = ids.to(device=dev, dtype=torch.int32).contiguous()
    out_keys = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vdb_merge_small_k(
            keys.data_ptr(), ids.data_ptr(), q_n, n, k, out_keys.data_ptr(),
            out_ids.data_ptr(), empty_id, stream)
    if err != 0:
        raise RuntimeError(f"merge_small_k kernel failed: CUDA error {err}")
    record("merge_small_k")
    return out_keys, out_ids
