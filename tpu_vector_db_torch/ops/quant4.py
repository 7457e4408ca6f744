"""int8 / int4 row quantization for the capacity-mode flat scan.

Counterpart of ``tpu_vector_db/ops/quant4.py``, byte-identical output.

Layout contract (shared with csrc/flat_topk.cu): packed column j holds
component j in its LOW nibble and component j + d/2 in its HIGH nibble,
each as an offset-8 value, with ONE f32 scale per row. For cosine stores
the scale folds the dequantized norm back to 1, so the scan's keys are
the true cosine of the stored point on the sphere.
"""

from __future__ import annotations

import torch

from tpu_vector_db_torch.ops.distance import row_sqnorms


def pack_int4(x: torch.Tensor, normalize: bool = True):
    """(n, d) f32 rows -> ((n, d//2) uint8 packed, (n,) f32 scales).

    d must be even. normalize=True rescales so the DEQUANTIZED row is
    exactly unit-norm (cosine stores); normalize=False keeps plain
    symmetric max-abs scaling (pair with ``dequant_sqnorms``)."""
    n, d = x.shape
    if d % 2:
        raise ValueError(f"pack_int4 needs an even dimension, got {d}")
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=1), min=1e-12) / 7.0
    q = torch.clamp(torch.round(x / scale[:, None]), -8, 7)
    if normalize:
        norm = torch.sqrt(row_sqnorms(q)) * scale
        scale = scale / torch.clamp(norm, min=1e-12)
    u = (q + 8.0).to(torch.uint8)
    lo = u[:, : d // 2]
    hi = u[:, d // 2:]
    return lo | (hi << 4), scale.float()


def quantize_unit_rows(x: torch.Tensor, storage_dtype: str):
    """The store quantizer for unit-norm cosine rows.

    'int8': fixed x127 scale (callers divide keys back by 127) ->
    ((n, d) int8, None). 'int4': ``pack_int4`` with unit-norm-preserving
    per-row scales -> ((n, d//2) uint8, (n,) f32)."""
    if storage_dtype == "int8":
        return (torch.clamp(torch.round(x * 127.0), -127, 127)
                .to(torch.int8), None)
    if storage_dtype == "int4":
        return pack_int4(x)
    raise ValueError(f"not a quantized storage dtype: {storage_dtype!r}")


def _nibbles(packed: torch.Tensor):
    lo = (packed & 15).float() - 8.0
    hi = (packed >> 4).float() - 8.0
    return lo, hi


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """((n, d//2) uint8, (n,) f32) -> (n, d) f32 dequantized rows."""
    lo, hi = _nibbles(packed)
    return torch.cat([lo, hi], dim=1) * scales[:, None]


def dequant_sqnorms(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Squared L2 norms of the dequantized rows (euclidean scan input)."""
    lo, hi = _nibbles(packed)
    return ((lo * lo).sum(dim=1) + (hi * hi).sum(dim=1)) * scales * scales
