"""tpu_vector_db_torch — the vector database on PyTorch and CUDA.

The port of ``tpu_vector_db`` (JAX/Pallas, built for the TPU) to an
NVIDIA H100. It imports torch, numpy and the standard library only, and
sets up no runtime at import. Modules mirror the JAX package's layout:

    ops/     distance, top-k, int4/int8 quantization, the plain blockwise
             scan, and the exact flat top-k scan (cuda_scan.py, kernels in
             csrc/flat_topk.cu, built with nvcc at first use)
    store/   config, persistence (the JAX package's on-disk format) and
             TorchVectorStore
    utils/   atomic writes, file lock, readers-writer lock, validation

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from tpu_vector_db_torch.store.config import VectorStoreConfig  # noqa: F401
from tpu_vector_db_torch.store.vector_store import (  # noqa: F401
    TorchVectorStore,
    create_vector_store,
)
