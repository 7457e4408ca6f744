"""The port's SDK (tpu_vector_db_torch/sdk) against the port's server.

The five cases of tests/test_sdk.py, with the port's SDK in place of the
JAX package's and the port's app on the CPU (``device="cpu"``) in place
of the JAX app: store lifecycle, adds with numpy input, queries to typed
results, batch add with progress, store context with auto-create, quick
helpers, no retry on 4xx, the sync facade over several calls. Then a
beam-graph store made through the SDK (``index_type="hnsw"``). The JAX
SDK against the port's server is tests/test_torch_serving_parity.py's.
"""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from tpu_vector_db_torch.sdk import ClientConfig, SearchResult, VectorDBClient

API_KEY = "tvdb_test_api_key_0123456789abc"
ADMIN_KEY = "tvdb_admin_test_key_0123456789"


@pytest.fixture
def server_factory(tmp_path):
    def make():
        from tpu_vector_db_torch.api.app import create_app
        from tpu_vector_db_torch.service.error_handler import ErrorHandler
        from tpu_vector_db_torch.service.manager import VectorStoreManager
        manager = VectorStoreManager(base_path=tmp_path / "stores",
                                     device="cpu",
                                     errors=ErrorHandler(tmp_path / "logs"))
        return TestServer(create_app(manager=manager))
    return make


def client_for(server) -> VectorDBClient:
    return VectorDBClient(ClientConfig(
        base_url=str(server.make_url("/")).rstrip("/"),
        api_key=API_KEY, admin_key=ADMIN_KEY,
        retry_base_delay_s=0.01))


def test_sdk_lifecycle(server_factory, rng):
    async def go():
        server = server_factory()
        await server.start_server()
        try:
            async with client_for(server) as client:
                health = await client.health_check()
                assert health["status"] in ("healthy", "degraded")

                await client.create_store("u", "m", dimension=32)
                assert await client.store_exists("u", "m")
                assert not await client.store_exists("u", "ghost")

                vectors = rng.standard_normal((50, 32)).astype(np.float32)
                out = await client.add_vectors(
                    "u", "m", vectors, [{"i": i} for i in range(50)])
                assert out["total"] == 50
                assert await client.count_vectors("u", "m") == 50

                results = await client.query_vectors("u", "m", vectors[9], k=3)
                assert isinstance(results[0], SearchResult)
                assert results[0].index == 9
                assert results[0].similarity > 0.999
                assert results[0].metadata == {"i": 9}

                batches = await client.batch_query_vectors(
                    "u", "m", vectors[:4], k=2)
                assert [b[0].index for b in batches] == [0, 1, 2, 3]

                stores = await client.list_stores()
                assert any(s["model_id"] == "m" for s in stores)

                stats = await client.get_store_stats("u", "m")
                assert stats["vector_count"] == 50

                await client.delete_store("u", "m", force=True)
                assert not await client.store_exists("u", "m")
        finally:
            await server.close()
    asyncio.run(go())


def test_sdk_batch_add_with_progress(server_factory, rng):
    async def go():
        server = server_factory()
        await server.start_server()
        try:
            async with client_for(server) as client:
                vectors = rng.standard_normal((300, 16)).astype(np.float32)
                out = await client.batch_add_vectors(
                    "u", "big", vectors, chunk_size=100)
                assert out["status"] == "completed"
                assert out["result"]["added"] == 300
                assert await client.count_vectors("u", "big") == 300
        finally:
            await server.close()
    asyncio.run(go())


def test_sdk_store_context_and_quick(server_factory, rng):
    async def go():
        server = server_factory()
        await server.start_server()
        try:
            async with client_for(server) as client:
                vectors = rng.standard_normal((20, 24)).astype(np.float32)
                async with client.store_context("ctx", "s1",
                                                dimension=24) as store:
                    await store.add(vectors)
                    assert await store.count() == 20
                    res = await store.query(vectors[5], k=1)
                    assert res[0].index == 5

                await client.quick_add("q", "auto", vectors)
                res = await client.quick_search("q", "auto", vectors[3], k=1)
                assert res[0].index == 3

                res = await client.semantic_search(
                    "q", "auto", vectors[3], k=10, min_similarity=0.999)
                assert len(res) == 1 and res[0].index == 3
        finally:
            await server.close()
    asyncio.run(go())


def test_sdk_retry_skips_4xx(server_factory):
    async def go():
        server = server_factory()
        await server.start_server()
        try:
            import httpx
            async with client_for(server) as client:
                with pytest.raises(httpx.HTTPStatusError) as exc:
                    await client.query_vectors("no", "store", [0.0] * 8, k=1)
                assert exc.value.response.status_code == 404
                assert client.get_stats()["retries"] == 0  # 4xx: no retry
        finally:
            await server.close()
    asyncio.run(go())


def test_sync_client_multi_call(server_factory, rng):
    """The sync facade must survive MULTIPLE calls: the old
    asyncio.run()-per-call implementation reused the httpx keepalive pool
    across event loops, so the second call picked a connection bound to a
    closed loop and raised 'Event loop is closed' (review finding). The
    facade now owns one background loop for its lifetime."""
    import threading

    from tpu_vector_db_torch.sdk.client import create_client

    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    server = server_factory()
    asyncio.run_coroutine_threadsafe(server.start_server(), loop).result()
    try:
        with create_client(
                base_url=str(server.make_url("/")).rstrip("/"),
                api_key=API_KEY, admin_key=ADMIN_KEY, sync=True) as sync:
            h1 = sync.health_check()
            h2 = sync.health_check()          # old impl died here
            assert h1["status"] and h2["status"]
            sync.create_store("su", "sm", dimension=16)
            vectors = rng.standard_normal((10, 16)).astype(np.float32)
            out = sync.add_vectors("su", "sm", vectors)
            assert out["added"] == 10
            res = sync.query_vectors("su", "sm", vectors[4], k=1)
            assert res[0].index == 4
            assert sync.count_vectors("su", "sm") == 10
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result()
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)


def test_sdk_graph_store(server_factory, rng):
    """A beam-graph store through the SDK: created with the hnsw alias,
    filled, and queried through the graph."""
    async def go():
        server = server_factory()
        await server.start_server()
        try:
            async with client_for(server) as client:
                await client.create_store(
                    "g", "hnsw", dimension=24, index_type="hnsw",
                    ann_params={"M": 8, "ef_construction": 64})
                vectors = rng.standard_normal((500, 24)).astype(np.float32)
                out = await client.batch_add_vectors(
                    "g", "hnsw", vectors, [{"i": i} for i in range(500)],
                    chunk_size=250)
                assert out["status"] == "completed"
                stats = await client.get_store_stats("g", "hnsw")
                assert stats["index_type"] == "beam_graph"
                assert stats["vector_count"] == 500
                rows = await client.batch_query_vectors(
                    "g", "hnsw", vectors[[3, 250, 499]], k=2)
                assert [r[0].index for r in rows] == [3, 250, 499]
                assert rows[1][0].metadata == {"i": 250}
        finally:
            await server.close()
    asyncio.run(go())
