"""The plain reference of the IVF_SQ8 + refine deployment: an inverted
file over 8-bit scalar quantized cosine rows whose candidates are
refined in float32 (Milvus's ``IVF_SQ8`` with ``refine``, FAISS's
``IVF...,SQ8`` under ``IndexRefineFlat``).

Plain torch, with no kernel, cache or batching of the program's, and
nothing of the program imported. It takes the index's layout as given
data, read from the store's index by the caller: the centroids (C, d),
the bucket id table (NB, Bc) (-1 = an empty slot) and the bucket to
cluster map (NB,) (-1 = a dead bucket). From those, and the rows and
queries the benchmark made, it computes anew, a block of queries at a
time:

1. the ``nprobe`` buckets of each query by descending centroid cosine
   (a bucket scores its cluster's centroid), ties to the lower bucket,
   dead buckets never;
2. the live int8 rows of those buckets (``reference_int8.quantize``),
   each scored as the float32 sum of the products of its components with
   the unit query rounded to bfloat16, divided by 127;
3. the candidates: the ``oversample * k`` best sums, ties to the lower
   id;
4. the candidates scored again by float32 cosine against the original
   rows (``reference_int8.Int8Reference.refine``), and the k best.

Float32 products run with TF32 off. Departures from the store, none of
which moves an answer past float32 rounding:

* the centroid scores are one float32 product of another shape than
  the store's, and the query is normalised in another order, so two
  buckets whose scores lie within a rounding may rank the other way at
  the ``nprobe``-th place (``bucket_margin`` gives each query's gap there,
  which ``agreement`` reads as a near-tie);
* the probed rows are scored together, and their sums run in another
  order than the store's probe by probe products: two keys within a
  rounding of each other may swap the last candidate (the store merges
  its probes into one running top-k; with ids distinct across buckets
  that is the same top-k as one sort of every probed row);
* candidates are chosen on the sums before the division by 127, as the
  store chooses them; the keys reported are the sums over 127;
* as in ``reference_int8``: rows, queries and refined scores are
  reduced by torch row by row alone.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark_h100 import reference_int8
from benchmark_h100.reference_int8 import SCALE, Answer, unit

Q_BLOCK = 8            # queries a block: (8, nprobe x Bc, d) rows widened
# two centroid scores of unit vectors in other summation orders
BUCKET_TOL = 1e-5


class IvfInt8Reference(reference_int8.Int8Reference):
    """The deployment's answers over ``rows`` ((n, d) float32, on the
    device it computes on), probing ``nprobe`` buckets of the layout
    (``centroids`` (C, d), ``bucket_ids`` (NB, Bc), ``bucket_cluster``
    (NB,), any array type). ``candidates`` gives the probe's best keys,
    ``search`` (inherited) the refined top-k; ``bucket_margin`` holds,
    for the queries of the last ``candidates`` call, the gap between
    the last bucket probed and the best one left out, of another
    cluster (inf where none is left out)."""

    def __init__(self, rows: torch.Tensor, centroids, bucket_ids,
                 bucket_cluster, nprobe: int) -> None:
        super().__init__(rows)
        dev = rows.device
        self.centroids = torch.as_tensor(np.asarray(centroids),
                                         dtype=torch.float32).to(dev)
        self.bucket_ids = torch.as_tensor(np.asarray(bucket_ids),
                                          dtype=torch.int64).to(dev)
        self.bucket_cluster = torch.as_tensor(np.asarray(bucket_cluster),
                                              dtype=torch.int64).to(dev)
        live = int((self.bucket_cluster >= 0).sum())
        self.nprobe = min(int(nprobe), live)
        self.bucket_margin = np.zeros(0)

    def buckets(self, q: torch.Tensor):
        """(sel (Q, nprobe), margin (Q,)): the probed buckets of the
        unit queries ``q``, best first, ties to the lower bucket."""
        cscore = q @ self.centroids[:, :q.shape[1]].T          # (Q, C)
        dead = self.bucket_cluster < 0
        bscore = cscore[:, self.bucket_cluster.clamp(min=0)]
        bscore = bscore.masked_fill(dead[None, :], float("-inf"))
        order = torch.sort(bscore, dim=1, descending=True,
                           stable=True).indices
        sel = order[:, :self.nprobe]
        # the best bucket left out whose cluster is not probed (a spill
        # bucket of a probed cluster ties its cluster's score exactly)
        probed = torch.zeros(q.shape[0], self.centroids.shape[0],
                             dtype=torch.bool, device=q.device)
        probed.scatter_(1, self.bucket_cluster[sel].clamp(min=0), True)
        out = probed[:, self.bucket_cluster.clamp(min=0)] | dead[None, :]
        rest = bscore.masked_fill(out, float("-inf")).amax(dim=1)
        last = torch.gather(bscore, 1, sel[:, -1:])[:, 0]
        return sel, (last - rest).double().cpu().numpy()

    def candidates(self, queries: torch.Tensor, m: int):
        """(keys (Q, m) float32, ids (Q, m) int64) of the m best int8
        keys among each query's probed rows, descending, ties to the
        lower id; -inf and -1 past the live rows probed."""
        dev = self.rows.device
        keys_out, ids_out, margins = [], [], []
        for qs in range(0, queries.shape[0], Q_BLOCK):
            qu = unit(queries[qs:qs + Q_BLOCK].to(dev))
            sel, margin = self.buckets(qu)
            margins.append(margin)
            ids = self.bucket_ids[sel].reshape(qu.shape[0], -1)
            # ids rising along each row, the empty slots (-1) first
            ids = torch.sort(ids, dim=1).values
            rows = self.codes[ids.clamp(min=0)].float()
            qb = qu.bfloat16().float()
            sums = torch.bmm(rows, qb[:, :, None])[:, :, 0]
            sums = sums.masked_fill(ids < 0, float("-inf"))
            k_b, i_b = reference_int8._best(sums, ids, min(m, ids.shape[1]))
            i_b = i_b.masked_fill(torch.isinf(k_b), -1)
            if k_b.shape[1] < m:
                pad = m - k_b.shape[1]
                k_b = torch.nn.functional.pad(k_b, (0, pad),
                                              value=float("-inf"))
                i_b = torch.nn.functional.pad(i_b, (0, pad), value=-1)
            keys_out.append(k_b / SCALE)
            ids_out.append(i_b)
        self.bucket_margin = np.concatenate(margins)
        return torch.cat(keys_out), torch.cat(ids_out)


def agreement(ids, scores, ans: Answer, bucket_margin,
              bucket_tol: float = BUCKET_TOL, **tols) -> dict:
    """``reference_int8.agreement``, with one more near-tie: a query
    whose ids differ where its ``bucket_margin`` is within
    ``bucket_tol`` (the last bucket probed and the best one left out
    score within a rounding, so the store may probe the other). The ids
    both answers share must still have scores within the score
    tolerance."""
    out = reference_int8.agreement(ids, scores, ans, **tols)
    edge = ~out["same"] & ~out["near_tie"] & (
        np.asarray(bucket_margin) <= bucket_tol)
    score_tol = tols.get("score_tol", reference_int8.SCORE_TOL)
    out["near_tie"] = out["near_tie"] | edge
    out["bad"] = (~out["same"] & ~out["near_tie"]) | (
        out["score_err"] > score_tol)
    return out
