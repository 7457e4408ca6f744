"""Process-wide torch settings for the server, applied once at startup.

1. Matmul precision. TF32 rounds f32 products to a 10-bit mantissa; the
   exact flat scan's plain version (``ops/cuda_scan.py``) and every f32
   score the server returns rely on full f32 products, so TF32 is turned
   off for matmuls and cuDNN.

2. The default device. ``"cuda"`` unless ``VDB_FORCE_CPU`` is set, which
   is the caller asking for the CPU (the same variable the JAX package's
   runtime reads). Nothing falls back to the CPU when CUDA is missing: the
   store and the startup probe raise.

The JAX package also keeps a persistent XLA compile cache here
(``VDB_COMPILE_CACHE``). It has no counterpart: the CUDA kernels are
built by ``nvcc`` into ``tpu_vector_db_torch/_build/`` at first use and
reused from there by every later process.
"""

from __future__ import annotations

import os

import torch


def setup_runtime() -> str:
    """Idempotent; called from ``create_app``. Returns the default
    device, ``"cpu"`` or ``"cuda"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cpu" if os.environ.get("VDB_FORCE_CPU") else "cuda"
