"""Python SDK (async httpx + sync wrapper).

Counterpart of the reference's sdk/python pair (mlx_vector_client.py — the
full async client — and the earlier mlx_vector_db_client.py; SURVEY.md §2.J).
The port's copy of ``tpu_vector_db/sdk``: httpx and numpy only.
"""

from tpu_vector_db_torch.sdk.client import (  # noqa: F401
    ClientConfig,
    SearchResult,
    StoreContext,
    VectorDBClient,
    SyncVectorDBClient,
    create_client,
)
