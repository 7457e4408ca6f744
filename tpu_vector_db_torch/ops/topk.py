"""Partial top-k primitives with a fixed tie order.

Counterpart of ``tpu_vector_db/ops/topk.py``. Order is key descending,
then id ascending: the order the JAX package's first-occurrence rule
gives, since its ids rise in scan order. ``torch.topk`` leaves ties in
no stated order, so these sort stably instead.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
# largest k of the warp-level merge (merge_small_k, csrc/topk_common.cuh)
# that both k <= 32 scans end in: one list entry a lane
MERGE_SMALL_MAX_K = 32


def top_k(scores: torch.Tensor, k: int, largest: bool = True):
    """Top-k along the last axis; ties go to the lower index. Returns
    (values, indices int32). ``largest=False`` gives bottom-k."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def sort_by_key_then_id(values: torch.Tensor, indices: torch.Tensor):
    """Sort the last axis by key descending, then id ascending."""
    by_id = torch.argsort(indices, dim=-1, stable=True)
    values = torch.take_along_dim(values, by_id, dim=-1)
    indices = torch.take_along_dim(indices, by_id, dim=-1)
    by_key = torch.argsort(values, dim=-1, descending=True, stable=True)
    return (torch.take_along_dim(values, by_key, dim=-1),
            torch.take_along_dim(indices, by_key, dim=-1))


def merge_topk(values_a, indices_a, values_b, indices_b, k: int):
    """Merge two top-k candidate sets (last axis) into one top-k, ties to
    the lower id. Inputs (..., ka) and (..., kb); output (..., k)."""
    vals = torch.cat([values_a, values_b], dim=-1)
    idx = torch.cat([indices_a, indices_b], dim=-1)
    vals, idx = sort_by_key_then_id(vals, idx)
    k = min(k, vals.shape[-1])
    return vals[..., :k], idx[..., :k]


def topk_with_mask(scores: torch.Tensor, mask: torch.Tensor | None, k: int):
    """Top-k with an optional validity mask (invalid rows score -inf)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return top_k(scores, k)


def to_host(keys: torch.Tensor, ids: torch.Tensor):
    """(Q, k) keys and ids on the host in ONE device-to-host copy, the
    keys viewed as int32 beside the ids: (keys f32, ids i32) numpy."""
    k = keys.shape[-1]
    packed = torch.cat([keys.float().view(torch.int32),
                        ids.to(torch.int32)], dim=-1).cpu().numpy()
    return np.ascontiguousarray(packed[:, :k]).view(np.float32), packed[:, k:]
