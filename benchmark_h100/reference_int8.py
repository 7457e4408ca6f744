"""The plain reference of the int8 capacity deployment: an 8-bit scalar
quantized cosine scan whose candidates are refined in float32 (FAISS's
SQ8 with ``IndexRefineFlat``, Milvus's SQ with ``refine``).

Plain torch, with no kernel, cache or batching of the program's, and
nothing of the program imported. It follows the semantics the store
documents for ``storage_dtype="int8"`` and ``batch_query(..., k,
rerank=True)``, written anew:

1. rows are unit-normalised and quantised as ``round(x * 127)``
   clamped to [-127, 127];
2. queries are unit-normalised and rounded to bfloat16; a row's key is
   the float32 sum of the products of the query with the row's int8
   components, divided by 127;
3. the candidates are the ``oversample * k`` best keys, ties to the
   lower id;
4. each candidate is scored again by float32 cosine against the
   original float32 row and query, and the k best are returned, ties to
   the earlier candidate.

Float32 products run with TF32 off. Departures from the store, none of
which moves an answer past float32 rounding:

* keys are one float32 matrix product a block of rows, summed in
  another order than the kernel's tensor cores sum them, so two keys
  within a rounding of each other may rank the other way (and so swap
  the last candidate);
* candidates are chosen on the sums before the division by 127, as the
  kernel chooses them; the keys reported are the sums over 127 (the
  store multiplies by a float32 1/127, which can differ by a rounding);
* rows, queries and the refined scores are reduced by torch row by row
  alone (the store pads a call of fewer than 16 rows on the card, so
  its sums may run in another order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Q_BLOCK = 256          # queries a block
ROW_BLOCK = 1 << 18    # rows a block of the (Q, rows) key matrix
SCALE = 127.0
EPS = 1e-8
# two int8 keys (sums over 127) in other summation orders: the kernel's
# and this matrix product's sums of 768 products differ by float32
# rounding, ~1e-6 on keys of O(1)
KEY_TOL = 1e-5
# two float32 cosines of unit rows in other summation orders
SCORE_TOL = 1e-6


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        EPS)


def quantize(rows: torch.Tensor) -> torch.Tensor:
    """int8 codes of the unit rows: round(x * 127), clamped to +-127."""
    return torch.clamp(torch.round(unit(rows) * SCALE), -127, 127).to(
        torch.int8)


def _best(keys: torch.Tensor, ids: torch.Tensor, m: int):
    """The m largest keys of each row, ties to the lower id, given
    ``ids`` rising along each row: a stable sort keeps the lower id
    first among equal keys."""
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    order = order[:, :m]
    return torch.gather(keys, 1, order), torch.gather(ids, 1, order)


class Answer(NamedTuple):
    """``scores``, ``ids`` (Q, k): the answer. ``keys`` (Q, m + 1): the
    int8 keys of the best m + 1 rows, the last one the first left out.
    ``refined`` (Q, m): every candidate's refined score, best first."""
    scores: torch.Tensor
    ids: torch.Tensor
    keys: torch.Tensor
    refined: torch.Tensor


class Int8Reference:
    """The deployment's answers over ``rows`` ((n, d) float32, on the
    device it computes on). ``candidates`` gives the int8 scan's best
    keys; ``search`` the refined top-k."""

    def __init__(self, rows: torch.Tensor) -> None:
        self._flags = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.rows = rows
        self.codes = torch.empty(rows.shape, dtype=torch.int8,
                                 device=rows.device)
        for s in range(0, rows.shape[0], ROW_BLOCK):
            self.codes[s:s + ROW_BLOCK] = quantize(rows[s:s + ROW_BLOCK])

    def close(self) -> None:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._flags

    def candidates(self, queries: torch.Tensor, m: int):
        """(keys (Q, m) float32, ids (Q, m) int64) of the m best int8
        keys of each query, descending, ties to the lower id."""
        dev = self.rows.device
        n = self.rows.shape[0]
        m = min(m, n)
        keys_out, ids_out = [], []
        for qs in range(0, queries.shape[0], Q_BLOCK):
            q = unit(queries[qs:qs + Q_BLOCK].to(dev)).bfloat16().float()
            best_k = best_i = None
            for s in range(0, n, ROW_BLOCK):
                block = self.codes[s:s + ROW_BLOCK]
                sums = q @ block.float().T
                ids = torch.arange(s, s + block.shape[0], device=dev).expand(
                    q.shape[0], -1)
                k_b, i_b = _best(sums, ids, m)
                if best_k is not None:
                    # the earlier blocks' ids are the lower ones
                    k_b, i_b = _best(torch.cat([best_k, k_b], 1),
                                     torch.cat([best_i, i_b], 1), m)
                best_k, best_i = k_b, i_b
            keys_out.append(best_k / SCALE)
            ids_out.append(best_i)
        return torch.cat(keys_out), torch.cat(ids_out)

    def refine(self, queries: torch.Tensor, cand: torch.Tensor):
        """(scores (Q, m) float32, ids (Q, m) int64): the candidates
        ``cand`` (Q, m) scored again by float32 cosine against the
        original rows, best first, ties to the earlier candidate."""
        dev = self.rows.device
        q = unit(queries.to(dev))
        scores = torch.empty(cand.shape, dtype=torch.float32, device=dev)
        for qs in range(0, q.shape[0], Q_BLOCK):
            r = unit(self.rows[cand[qs:qs + Q_BLOCK]])
            scores[qs:qs + Q_BLOCK] = (r * q[qs:qs + Q_BLOCK, None, :]).sum(
                dim=2).clamp(-1.0, 1.0)
        order = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices
        return torch.gather(scores, 1, order), torch.gather(cand, 1, order)

    def search(self, queries: torch.Tensor, k: int,
               oversample: int = 4) -> Answer:
        """The deployment's answer to each query at ``k``, with what a
        comparison needs to tell a near-tie (``Answer``)."""
        m = oversample * k
        keys, cand = self.candidates(queries, m + 1)
        scores, ids = self.refine(queries, cand[:, :m])
        return Answer(scores[:, :k], ids[:, :k], keys, scores)


def agreement(ids, scores, ans: Answer, key_tol: float = KEY_TOL,
              score_tol: float = SCORE_TOL) -> dict:
    """Another answer (``ids``, ``scores`` (Q, k) arrays) held to
    ``ans``. A query agrees where its ids are the reference's, in order,
    and every score is within ``score_tol``; a query whose ids differ is
    a near-tie where the reference's last candidate and the first row
    left out have keys within ``key_tol`` (the int8 keys of two rows tie
    within float32 rounding at the edge of the candidates) or two of its
    first k + 1 refined scores are within ``score_tol`` (a tie in the
    refined order or at the k-th place); there the ids both answers
    share must have scores within ``score_tol``. Returns numpy arrays
    (Q,): ``same``, ``near_tie``, ``bad`` (neither), and ``score_err``,
    the largest gap of a shared id's score."""
    ids = np.asarray(ids)
    scores = np.asarray(scores, np.float64)
    r_ids = ans.ids.cpu().numpy()
    r_sc = ans.scores.double().cpu().numpy()
    keys = ans.keys.double().cpu().numpy()
    refined = ans.refined.double().cpu().numpy()
    k = r_ids.shape[1]
    same = (ids == r_ids).all(axis=1)
    edge = keys[:, -2] - keys[:, -1] <= key_tol
    first = refined[:, :k + 1]
    order_tie = (first[:, :-1] - first[:, 1:] <= score_tol).any(axis=1)
    err = np.zeros(len(ids))
    for q in range(len(ids)):
        ref = dict(zip(r_ids[q].tolist(), r_sc[q].tolist()))
        gaps = [abs(s - ref[i]) for i, s in zip(ids[q].tolist(),
                                                scores[q].tolist())
                if i in ref]
        err[q] = max(gaps, default=0.0)
    near = ~same & (edge | order_tie)
    bad = (~same & ~near) | (err > score_tol)
    return {"same": same, "near_tie": near, "bad": bad, "score_err": err}
