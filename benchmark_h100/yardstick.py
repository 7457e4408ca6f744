"""The least time a kernel launch could take on one NVIDIA H100 SXM.

Frozen copies of ``chip_smoke.py``'s ``bound`` and ``ivf_bound``: the
larger of the bytes a launch must move over the memory rate and the
operations it must do over the peak rate of its row type. Each input
byte counts once and each output byte once, whatever the kernel reads
again. Peaks are NVIDIA's published SXM figures, dense, at the card's
full 700 W (the run prints the card's ``power.limit`` beside them).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,      # CUDA cores, f32 (no tensor cores)
            "bfloat16": 989e12, "int8": 989e12, "int4": 989e12}


def bound(rows: int, row_bytes: int, q_n: int, d: int, k: int, dtype: str,
          side_streams: int = 0) -> tuple[float, str]:
    """A flat scan of ``rows`` rows for ``q_n`` queries: bytes (rows read
    once, per-row side streams, the f32 queries, the (key, id) outputs)
    against 2*Q*rows*d operations. Returns (ms, "bytes"|"operations")."""
    nbytes = rows * row_bytes + side_streams + q_n * d * 4 + q_n * k * 8
    ops = 2.0 * q_n * rows * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ivf_bound(fills, sel, row_bytes: int, d: int, k: int,
              dtype: str) -> tuple[float, str]:
    """An IVF probe: bytes (the live rows of the distinct probed buckets
    read once, ``sel``, the fills of the distinct buckets, the queries,
    the outputs) against 2*d operations per live (query, row) pair.
    ``fills`` (NB,) and ``sel`` (Q, nprobe) are integer tensors."""
    import torch
    f = fills.long()
    distinct = torch.unique(sel)
    rows_read = int(f[distinct.long()].sum())
    pairs = int(f[sel.long()].sum())
    q_n = sel.shape[0]
    nbytes = (rows_read * row_bytes + sel.numel() * 4 + distinct.numel() * 4
              + q_n * d * 4 + q_n * k * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * d * pairs / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
