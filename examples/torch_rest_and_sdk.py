#!/usr/bin/env python
"""Server + SDK example: start the REST server in-process, drive it with the
async SDK (store context, batch ingest with progress, semantic search).

The PyTorch port's version of ``examples/rest_and_sdk.py``: the port's
aiohttp app (``tpu_vector_db_torch.api``), its stores on the CUDA card
unless ``--device cpu``, driven by the port's SDK
(``tpu_vector_db_torch.sdk``).

  python examples/torch_rest_and_sdk.py [--device cpu] [--root DIR]
"""

import argparse
import asyncio
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


async def serve_and_drive(device: str, base: Path, n: int, d: int) -> dict:
    from aiohttp.test_utils import TestServer
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.sdk import ClientConfig, VectorDBClient
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager

    manager = VectorStoreManager(base_path=base, device=device,
                                 errors=ErrorHandler(base / "logs"))
    server = TestServer(create_app(manager=manager))
    await server.start_server()
    print(f"server at {server.make_url('/')}")

    cfg = ClientConfig(base_url=str(server.make_url("/")).rstrip("/"),
                       api_key=os.environ["VECTOR_DB_API_KEY"],
                       admin_key=os.environ["VECTOR_DB_ADMIN_KEY"])
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    out = {"vectors": vectors}

    async with VectorDBClient(cfg) as client:
        out["health"] = (await client.health_check())["status"]
        print("health:", out["health"])

        # scoped store helper with auto-create
        async with client.store_context("demo", "docs",
                                        dimension=d) as store:
            await store.add(vectors[:100],
                            [{"i": i} for i in range(100)])
            out["count"] = await store.count()
            print("count:", out["count"])
            results = await store.query(vectors[7], k=3)
            out["top_hit"] = (results[0].index, results[0].similarity)
            print("top hit:", results[0].index, results[0].similarity)

        # chunked batch ingest with progress tracking (v1 batch API)
        batch = await client.batch_add_vectors("demo", "docs", vectors[100:],
                                               chunk_size=100)
        out["batch_add"] = (batch["status"], batch["result"])
        print("batch add:", batch["status"], batch["result"])

        # one-liners
        hits = await client.semantic_search("demo", "docs", vectors[300],
                                            k=5, min_similarity=0.5)
        out["semantic_hits"] = [h.index for h in hits]
        print("semantic search hits:", out["semantic_hits"])
        out["client_stats"] = client.get_stats()
        print("client stats:", out["client_stats"])

    out["store"] = manager.get_store("demo", "docs")
    await server.close()
    return out


def main(device: str = "cuda", root=None, n: int = 500,
         d: int = 64) -> dict:
    """The server on ``device``, its stores under ``root`` (default: the
    system's temporary directory), driven by the SDK. Returns what it
    printed, the rows it sent and the store that answered."""
    from tpu_vector_db_torch.security.auth import reload_auth
    os.environ.setdefault("VECTOR_DB_API_KEY",
                          "tvdb_example_api_key_0123456789")
    os.environ.setdefault("VECTOR_DB_ADMIN_KEY",
                          "tvdb_example_admin_0123456789")
    reload_auth()        # the server's keys: the ones the client sends
    base = Path(root or tempfile.gettempdir()) / "vdb_sdk_example"
    return asyncio.run(serve_and_drive(device, base, n, d))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--root", default=None,
                    help="directory of the server's stores (default: the "
                         "system's temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root)
