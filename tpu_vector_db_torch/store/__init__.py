"""Vector store layer: device-resident matrix + host metadata + persistence."""

from tpu_vector_db_torch.store.config import VectorStoreConfig  # noqa: F401
from tpu_vector_db_torch.store.vector_store import (  # noqa: F401
    TorchVectorStore,
    create_vector_store,
)
