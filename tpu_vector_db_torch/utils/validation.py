"""Input validation helpers (counterpart of reference utils.py:28-41)."""

from __future__ import annotations

import numpy as np


def validate_vector_shape(vectors: np.ndarray, dimension: int) -> np.ndarray:
    """Coerce to a float32 (N, dimension) matrix or raise ValueError."""
    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"vectors must be 1-D or 2-D, got {arr.ndim}-D")
    if arr.shape[1] != dimension:
        raise ValueError(
            f"vector dimension {arr.shape[1]} != store dimension {dimension}")
    if not np.all(np.isfinite(arr)):
        raise ValueError("vectors contain NaN or Inf")
    return arr
