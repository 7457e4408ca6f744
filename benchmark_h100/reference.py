"""The plain reference: exact cosine top-k over the rows the benchmark made.

Plain torch, with no kernel, cache or batching of the program's, and
nothing of the program imported. It works from the rows and queries of
``datagen`` (the same the program was given) and never from what the
program derived from them. Float32 products run with TF32 off; the keys
of the ids an answer names are worked out again in float64.

``tf32=True`` computes the same top-k with TF32 matrix products on the
card (on the CPU, whose matmul has no TF32, with inputs rounded to TF32's
10-bit mantissa): the benchmark's control, one precision below the
configuration's float32.
"""

from __future__ import annotations

import numpy as np
import torch

Q_BLOCK = 512          # queries a block of the (Q, N) f32 key matrix
EXTRA = 8              # candidates past k re-ranked in float64


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest at TF32's 10 stored mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(q: torch.Tensor, rows: torch.Tensor, tf32: bool):
    if not tf32:
        return q @ rows.T
    if q.device.type != "cuda":
        return round_tf32(q) @ round_tf32(rows).T
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return q @ rows.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class Reference:
    """Exact top-k of each pool query over ``rows`` (both (n, d) f32 on
    one device), with float64 keys.

    ``top(k)`` -> (keys float64 (P, k), ids int64 (P, k)), descending;
    ``keys_of(qidx, ids)`` -> float64 cosine of each (query, id) pair."""

    def __init__(self, rows: torch.Tensor, pool: torch.Tensor) -> None:
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._tf32_flags = old
        self.rows = rows
        self.pool = pool
        self._q64 = unit(pool.double())
        self._norms = torch.linalg.vector_norm(rows.double(), dim=1)

    def close(self) -> None:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._tf32_flags

    def keys_of(self, qidx: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """float64 cosine of pool query qidx[i] with row ids[i, j]
        (ids (A, m) int, qidx (A,)); ids < 0 give -inf."""
        dev = self.rows.device
        qi = torch.as_tensor(np.asarray(qidx), dtype=torch.long, device=dev)
        ii = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
        out = torch.full(ii.shape, float("-inf"), dtype=torch.float64,
                         device=dev)
        step = max(1, (1 << 24) // max(1, ii.shape[1] * self.rows.shape[1]))
        for s in range(0, ii.shape[0], step):
            blk = ii[s:s + step]
            safe = blk.clamp(min=0)
            r = self.rows[safe].double() / self._norms[safe][..., None]
            keys = torch.einsum("amd,ad->am", r, self._q64[qi[s:s + step]])
            out[s:s + step] = torch.where(blk >= 0, keys, out[s:s + step])
        return out.cpu().numpy()

    def top(self, k: int, tf32: bool = False,
            queries: np.ndarray | None = None):
        """Exact top-k (float64 keys, ids) of the pool queries
        ``queries`` (all when None), ranked by f32 keys and re-ranked in
        float64 among the best k + EXTRA. With ``tf32`` the ranking and
        the keys are the TF32 products' (the control): no re-ranking."""
        idx = (np.arange(self.pool.shape[0]) if queries is None
               else np.asarray(queries))
        dev = self.rows.device
        qn = unit(self.pool.float())
        rn = self.rows
        keys_out, ids_out = [], []
        for s in range(0, len(idx), Q_BLOCK):
            sel = torch.as_tensor(idx[s:s + Q_BLOCK], dtype=torch.long,
                                  device=dev)
            scores = _matmul(qn[sel], rn, tf32)
            if tf32:
                vals, ids = torch.topk(scores, k, dim=1)
                keys_out.append(vals.double().cpu().numpy())
                ids_out.append(ids.cpu().numpy())
                continue
            _, cand = torch.topk(scores, min(k + EXTRA, rn.shape[0]), dim=1)
            del scores
            cand_np = cand.cpu().numpy()
            exact = self.keys_of(idx[s:s + Q_BLOCK], cand_np)
            order = np.lexsort((cand_np, -exact), axis=1)[:, :k]
            keys_out.append(np.take_along_axis(exact, order, 1))
            ids_out.append(np.take_along_axis(cand_np, order, 1))
        return np.concatenate(keys_out), np.concatenate(ids_out)
