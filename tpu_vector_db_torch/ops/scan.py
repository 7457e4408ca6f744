"""Blockwise flat scan + running top-k in plain torch.

Counterpart of ``tpu_vector_db/ops/scan.py::flat_scan_topk``, the JAX
package's portable engine: the database streams in row blocks, each
block's scores merge into a running (Q, k) top-k, so memory stays
O(Q * block) instead of O(Q * N).

``scan_blocks`` is the one blockwise loop of the port. Two scoring rules
run on it: ``flat_scan_topk`` here, with the JAX scan's numerics, and
``ops/cuda_scan.py::flat_topk_plain``, with the CUDA kernels' numerics
(the plain version the kernels are held against). The store calls
neither directly: its engine is ``cuda_scan.flat_topk``.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_vector_db_torch.ops import distance
from tpu_vector_db_torch.ops.topk import NEG_INF, merge_topk

DEFAULT_BLOCK_ROWS = 8192


def scan_blocks(block_keys: Callable[[int, int], torch.Tensor], n_rows: int,
                q_n: int, k: int, device, live: torch.Tensor | None = None,
                block_rows: int = DEFAULT_BLOCK_ROWS):
    """Running top-k over rows [0, n_rows).

    ``block_keys(start, stop)`` returns the (Q, stop - start) f32 keys of
    those rows; rows where the bool ``live`` (n_rows,) is False score
    -inf. Order is key descending, then id ascending. Returns (keys (Q,k)
    f32, ids (Q,k) i32); slots no row reached hold -inf and id 0."""
    best_vals = torch.full((q_n, k), NEG_INF, device=device)
    best_idx = torch.zeros((q_n, k), dtype=torch.int32, device=device)
    for start in range(0, n_rows, block_rows):
        stop = min(start + block_rows, n_rows)
        keys = block_keys(start, stop)
        if live is not None:
            keys = torch.where(live[None, start:stop], keys,
                               torch.full_like(keys, NEG_INF))
        ids = torch.arange(start, stop, dtype=torch.int32, device=device)
        best_vals, best_idx = merge_topk(
            best_vals, best_idx, keys, ids.expand(q_n, -1), k)
    return best_vals, best_idx


def flat_scan_topk(
    queries: torch.Tensor,       # (Q, d_pad)
    db: torch.Tensor,            # (N_pad, d_pad), rows >= count are zero pad
    count: int,                  # live rows
    k: int,
    metric: str = "cosine",
    db_normalized: bool = False,
    db_sqnorms: torch.Tensor | None = None,   # (N_pad,) ||x||^2 for L2
    filter_mask: torch.Tensor | None = None,  # (N_pad,) bool filter
    block_rows: int = DEFAULT_BLOCK_ROWS,
    db_scales: torch.Tensor | None = None,    # (N_pad,) int4 scales
):
    """Exact top-k over the whole store. Returns (keys (Q,k) f32,
    indices (Q,k) i32), keys in the maximize convention of
    ops/distance.py. Padding and filtered-out rows appear only when fewer
    than k rows are live.

    int4: db is (N_pad, d_pad//2) uint8 (ops/quant4.pack_int4) with
    db_scales; int8: the int8 rows are widened and scored against the f32
    queries; bf16: queries are rounded to bf16 first."""
    quant4 = db.dtype == torch.uint8
    if quant4 and db_scales is None:
        raise ValueError("uint8-packed int4 db needs db_scales")
    n_pad = db.shape[0]
    k = min(k, n_pad)

    if metric == "cosine" and not db_normalized and not quant4:
        db = distance.l2_normalize(db)
    qn = distance.l2_normalize(queries) if metric == "cosine" else queries
    if db.dtype != torch.int8 and not quant4:
        qn = qn.to(db.dtype)
    if quant4:
        q_bf = qn.to(torch.bfloat16).float()
        qsum8 = 8.0 * torch.sum(qn.float(), dim=1)
        q_sq = torch.sum(qn.float() ** 2, dim=1)

    def block_keys(start: int, stop: int) -> torch.Tensor:
        db_block = db[start:stop]
        sq_block = None if db_sqnorms is None else db_sqnorms[start:stop]
        if quant4:
            u = db_block.to(torch.int32)
            nib = torch.cat([u & 15, u >> 4], dim=1).float()
            cross = (q_bf @ nib.T - qsum8[:, None]) \
                * db_scales[start:stop][None, :]
            if metric == "euclidean":
                return 2.0 * cross - sq_block[None, :] - q_sq[:, None]
            return cross
        if metric in ("cosine", "dot", "dot_product"):
            return qn.float() @ db_block.float().T
        return -distance.squared_l2_distances(qn, db_block, sq_block)

    live = torch.arange(n_pad, device=db.device) < count
    if filter_mask is not None:
        live = live & filter_mask.bool()
    return scan_blocks(block_keys, n_pad, queries.shape[0], k, db.device,
                       live, block_rows)
