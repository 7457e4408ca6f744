"""Distance / similarity scoring on tensors.

Counterpart of ``tpu_vector_db/ops/distance.py``. Every product
accumulates in float32: bf16 and integer operands are widened to float32
before the product, which is what the JAX package's
``preferred_element_type=float32`` gives.

Score conventions (shared by both packages):

  metric      raw score s          similarity          distance
  cosine      cos(q, x)            s                   1 - s
  dot         <q, x>               s                   -s
  euclidean   ||q - x||_2          1 / (1 + s)         s

Search always maximizes a key: cosine/dot use s, euclidean uses
-||q-x||^2 (sqrt deferred to the final k results).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-8
LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(x: torch.Tensor, multiple: int = LANE) -> torch.Tensor:
    """Zero-pad the last (feature) dim to a multiple (a scoring no-op)."""
    d = x.shape[-1]
    d_pad = _round_up(d, multiple)
    if d_pad == d:
        return x
    return F.pad(x, (0, d_pad - d))


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the row (database) dim to a block multiple."""
    n = x.shape[0]
    n_pad = _round_up(n, multiple)
    if n_pad == n:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, n_pad - n))


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Row-wise L2 normalization with an eps clamp."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return (xf / torch.clamp(norm, min=eps)).to(x.dtype)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q,d) x (N,d) -> (Q,N), operands widened to float32."""
    return a.float() @ b.float().T


def cosine_scores(queries: torch.Tensor, db: torch.Tensor,
                  db_normalized: bool = False) -> torch.Tensor:
    """(Q,d) x (N,d) -> (Q,N) cosine similarity."""
    q = l2_normalize(queries)
    d = db if db_normalized else l2_normalize(db)
    return _matmul_f32(q, d)


def dot_scores(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q,d) x (N,d) -> (Q,N) inner products."""
    return _matmul_f32(queries, db)


def squared_l2_distances(queries: torch.Tensor, db: torch.Tensor,
                         db_sqnorms: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(Q,d) x (N,d) -> (Q,N) squared L2 via the matmul expansion
    ||q||^2 - 2<q,x> + ||x||^2, clamped at 0."""
    qf = queries.float()
    q_sq = torch.sum(qf * qf, dim=-1, keepdim=True)
    if db_sqnorms is None:
        dbf = db.float()
        db_sqnorms = torch.sum(dbf * dbf, dim=-1)
    cross = _matmul_f32(queries, db)
    return torch.clamp(q_sq - 2.0 * cross + db_sqnorms[None, :], min=0.0)


def euclidean_distances(queries: torch.Tensor, db: torch.Tensor,
                        db_sqnorms: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(Q,d) x (N,d) -> (Q,N) L2 distances."""
    return torch.sqrt(squared_l2_distances(queries, db, db_sqnorms))


def score_matrix(queries: torch.Tensor, db: torch.Tensor, metric: str,
                 db_normalized: bool = False,
                 db_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """(Q,N) maximize-key score matrix for any metric (euclidean: the
    NEGATED squared distance)."""
    if metric == "cosine":
        return cosine_scores(queries, db, db_normalized=db_normalized)
    if metric in ("dot_product", "dot"):
        return dot_scores(queries, db)
    if metric in ("euclidean", "l2"):
        return -squared_l2_distances(queries, db, db_sqnorms)
    raise ValueError(f"unknown metric: {metric!r}")


def key_to_raw_score(key: torch.Tensor, metric: str) -> torch.Tensor:
    """Convert the internal maximize-key back to the canonical raw score."""
    if metric in ("euclidean", "l2"):
        return torch.sqrt(torch.clamp(-key, min=0.0))
    return key


def raw_score_to_similarity_distance(score, metric: str):
    """Canonical (similarity, distance) pair from a raw score."""
    if metric == "cosine":
        return score, 1.0 - score
    if metric in ("dot_product", "dot"):
        return score, -score
    if metric in ("euclidean", "l2"):
        return 1.0 / (1.0 + score), score
    raise ValueError(f"unknown metric: {metric!r}")
