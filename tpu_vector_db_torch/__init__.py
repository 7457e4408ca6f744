"""tpu_vector_db_torch — the vector database on PyTorch and CUDA.

The port of ``tpu_vector_db`` (JAX/Pallas, built for the TPU) to an
NVIDIA H100. It imports torch, numpy and the standard library only, and
sets up no runtime at import. Modules mirror the JAX package's layout:

    ops/     distance, top-k, int4/int8 quantization, the plain blockwise
             scan, the exact flat top-k scan (cuda_scan.py, kernels in
             csrc/flat_topk.cu), k-means (kmeans.py) and the IVF probe
             scans (ivf_scan.py, kernel in csrc/ivf_topk.cu); kernels are
             built with nvcc at first use
    index/   IVFIndex: k-means buckets, appends with spills, ann_ivf.npz;
             BeamGraphIndex: batched beam search over a flat graph built
             on the device (or by the native C++ builder, native.py),
             incremental inserts, ann_graph.npz
    store/   config, persistence (the JAX package's on-disk format) and
             TorchVectorStore, with the JAX store's ANN routing
    utils/   atomic writes, file lock, readers-writer lock, validation
    service/ the multi-tenant store manager (its worker pool), the query
             coalescer, errors, circuit breakers, retries, degradation
    api/     the aiohttp REST server (``create_app``; ``python -m
             tpu_vector_db_torch`` serves it), routes, rate limiting
    sdk/     the HTTP client (httpx; touches no device)
    pipeline/
             tokenizers (with the native C++ fast paths of native/*.cpp),
             the BERT / XLM-R / MPNet encoders, the encoder registry and
             the RAG pipeline over TorchVectorStore
    core/, monitoring/, security/
             logging and torch settings, metrics and health checks, keys

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"`` (the server: ``VDB_FORCE_CPU=1``). Importing this package
does not import ``api/`` or ``sdk/``, so the library needs no aiohttp
and no httpx.
"""

__version__ = "0.1.0"

from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex  # noqa: F401
from tpu_vector_db_torch.index.ivf import IVFIndex  # noqa: F401
from tpu_vector_db_torch.store.config import VectorStoreConfig  # noqa: F401
from tpu_vector_db_torch.store.vector_store import (  # noqa: F401
    TorchVectorStore,
    create_vector_store,
)
