"""In-process REST API integration tests of the torch port's server.

The cases of tests/test_api.py, run against ``tpu_vector_db_torch``'s app
on the CPU (``device="cpu"``, every kernel's plain version), plus what is
particular to the port: beam-graph stores (``beam_graph`` and its
``hnsw`` alias) created, filled and queried where the port answered 501
before the graph was ported, the app's refusal to start on the CPU when
it was asked for the card, imports that touch no CUDA, and one case on
the card.
"""

import asyncio
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

API_KEY = "tvdb_test_api_key_0123456789abc"
ADMIN_KEY = "tvdb_admin_test_key_0123456789"
AUTH = {"Authorization": f"Bearer {API_KEY}"}
ADMIN = {"Authorization": f"Bearer {ADMIN_KEY}"}


def run(coro):
    return asyncio.run(coro)


def make_client(tmp_path, device: str = "cpu") -> TestClient:
    """The port's app on ``device``, its stores and its error log under
    tmp_path; built inside the running loop, the caller closes it."""
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    manager = VectorStoreManager(base_path=tmp_path / "stores", device=device,
                                 errors=ErrorHandler(tmp_path / "logs"))
    return TestClient(TestServer(create_app(manager=manager)))


@pytest.fixture
def client_factory(tmp_path):
    """Builds (app, client) inside the running loop; caller closes."""
    return lambda: make_client(tmp_path)


def test_banner_and_health(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.get("/")
            assert r.status == 200
            body = await r.json()
            assert body["service"] == "tpu-vector-db"

            r = await client.get("/health")
            assert r.status == 200
            body = await r.json()
            assert body["status"] in ("healthy", "degraded")
            assert "X-Response-Time" in r.headers
    run(go())


def test_auth_required(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.post("/vectors/add", json={})
            assert r.status == 401
            r = await client.post("/vectors/add", json={}, headers={
                "Authorization": "Bearer wrong-key"})
            assert r.status == 401
            # admin route rejects plain API key by default
            r = await client.post("/admin/create_store", json={}, headers=AUTH)
            assert r.status == 403
    run(go())


def test_full_lifecycle(client_factory, rng):
    async def go():
        async with client_factory() as client:
            # create
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "alice", "model_id": "m1", "dimension": 64})
            assert r.status == 201

            # duplicate -> 409
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "alice", "model_id": "m1", "dimension": 64})
            assert r.status == 409

            vectors = rng.standard_normal((100, 64)).astype(np.float32)
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "alice", "model_id": "m1",
                "vectors": vectors.tolist(),
                "metadata": [{"doc": f"doc_{i}", "lang": "en" if i % 2 else "de"}
                             for i in range(100)]})
            assert r.status == 200
            assert (await r.json())["total"] == 100

            r = await client.get("/vectors/count",
                                 params={"user_id": "alice", "model_id": "m1"},
                                 headers=AUTH)
            assert (await r.json())["count"] == 100

            # self-query: top-1 must be itself with similarity ~ 1.0
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "alice", "model_id": "m1",
                "query": vectors[7].tolist(), "k": 5})
            body = await r.json()
            assert r.status == 200
            top = body["results"][0]
            assert top["index"] == 7
            assert top["similarity"] > 0.999
            assert top["metadata"]["doc"] == "doc_7"
            assert abs(top["distance"] - (1 - top["similarity"])) < 1e-5

            # filtered query
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "alice", "model_id": "m1",
                "query": vectors[7].tolist(), "k": 5,
                "filter_metadata": {"lang": "de"}})
            body = await r.json()
            assert all(res["metadata"]["lang"] == "de"
                       for res in body["results"])

            # batch query (reference's 500-at-runtime surface, §2.1)
            r = await client.post("/vectors/batch_query", headers=AUTH, json={
                "user_id": "alice", "model_id": "m1",
                "queries": vectors[:4].tolist(), "k": 3})
            body = await r.json()
            assert r.status == 200
            assert len(body["results"]) == 4
            assert body["results"][2][0]["index"] == 2

            # stats include memory usage (reference omitted it, §2.1)
            r = await client.get("/vectors/stats",
                                 params={"user_id": "alice", "model_id": "m1"},
                                 headers=AUTH)
            assert (await r.json())["memory_usage_mb"] > 0

            # delete non-empty requires force
            r = await client.delete("/admin/store", headers=ADMIN, json={
                "user_id": "alice", "model_id": "m1"})
            assert r.status == 409
            r = await client.delete("/admin/store", headers=ADMIN, json={
                "user_id": "alice", "model_id": "m1", "force": True})
            assert r.status == 200
    run(go())


def test_validation_errors(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "u", "model_id": "m", "query": [0.0] * 8, "k": 0})
            assert r.status == 422
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "u", "model_id": "m", "vectors": []})
            assert r.status == 422
            r = await client.post("/vectors/query", headers=AUTH,
                                  data=b"not json")
            assert r.status == 400
            # query against a store that doesn't exist -> 404
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "ghost", "model_id": "none",
                "query": [0.0] * 8, "k": 3})
            assert r.status == 404
    run(go())


def test_batch_v1_progress_and_sse(client_factory, rng):
    async def go():
        async with client_factory() as client:
            vectors = rng.standard_normal((500, 32)).astype(np.float32)
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "bob", "model_id": "mb", "dimension": 32})
            assert r.status == 201
            r = await client.post("/v1/batch/add", headers=AUTH, json={
                "user_id": "bob", "model_id": "mb",
                "vectors": vectors.tolist(), "chunk_size": 100})
            assert r.status == 202
            op_id = (await r.json())["op_id"]

            # poll until completed
            for _ in range(100):
                r = await client.get(f"/v1/batch/operations/{op_id}",
                                     headers=AUTH)
                body = await r.json()
                if body["status"] == "completed":
                    break
                await asyncio.sleep(0.05)
            assert body["status"] == "completed"
            assert body["result"]["added"] == 500
            assert body["progress"]["percent"] == 100.0

            # operation listing
            r = await client.get("/v1/batch/operations", headers=AUTH)
            assert any(o["op_id"] == op_id
                       for o in (await r.json())["operations"])

            # SSE stream of a finished op yields at least one event + done
            r = await client.get(f"/v1/batch/operations/{op_id}/stream",
                                 headers=AUTH)
            text = (await r.read()).decode()
            assert "data: " in text and "event: done" in text

            # chunked batch query
            r = await client.post("/v1/batch/query", headers=AUTH, json={
                "user_id": "bob", "model_id": "mb",
                "queries": vectors[:10].tolist(), "k": 2, "chunk_size": 4})
            body = await r.json()
            assert len(body["results"]) == 10
            assert body["results"][3][0]["index"] == 3
    run(go())


def test_bulk_upload_npz(client_factory, rng):
    async def go():
        async with client_factory() as client:
            import aiohttp
            vectors = rng.standard_normal((50, 16)).astype(np.float32)
            buf = io.BytesIO()
            np.savez(buf, vectors=vectors)
            meta_lines = "\n".join(json.dumps({"i": i}) for i in range(50))

            form = aiohttp.FormData()
            form.add_field("user_id", "carol")
            form.add_field("model_id", "up1")
            form.add_field("vectors", buf.getvalue(),
                           filename="vectors.npz",
                           content_type="application/octet-stream")
            form.add_field("metadata", meta_lines.encode(),
                           filename="metadata.jsonl",
                           content_type="application/jsonl")
            r = await client.post("/v1/batch/upload", headers=AUTH, data=form)
            assert r.status == 202
            op_id = (await r.json())["op_id"]
            for _ in range(100):
                body = await (await client.get(
                    f"/v1/batch/operations/{op_id}", headers=AUTH)).json()
                if body["status"] in ("completed", "failed"):
                    break
                await asyncio.sleep(0.05)
            assert body["status"] == "completed"

            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "carol", "model_id": "up1",
                "query": vectors[3].tolist(), "k": 1})
            body = await r.json()
            assert body["results"][0]["index"] == 3
            assert body["results"][0]["metadata"] == {"i": 3}
    run(go())


def test_monitoring_and_metrics(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.get("/monitoring/health")
            assert r.status in (200, 503)
            r = await client.get("/monitoring/metrics", headers=AUTH)
            assert "summary" in await r.json()
            r = await client.get("/monitoring/prometheus", headers=AUTH)
            text = await r.text()
            assert "http_requests_total" in text
            assert "# TYPE" in text
            r = await client.get("/monitoring/status", headers=AUTH)
            assert "backend" in await r.json()
    run(go())


def test_rate_limit_headers_present(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.get("/vectors/count",
                                 params={"user_id": "x", "model_id": "y"},
                                 headers=AUTH)
            # 404 (no store) but rate-limit headers still attached
            assert "X-RateLimit-Limit" in r.headers
    run(go())


def test_performance_routes(client_factory, rng):
    async def go():
        async with client_factory() as client:
            r = await client.get("/performance/health", headers=AUTH)
            assert (await r.json())["status"] == "healthy"
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "perf", "model_id": "p1", "dimension": 16})
            assert r.status == 201
            await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "perf", "model_id": "p1",
                "vectors": rng.standard_normal((20, 16)).tolist()})
            r = await client.post("/performance/warmup", headers=AUTH, json={
                "user_id": "perf", "model_id": "p1"})
            assert r.status == 200
            r = await client.post("/performance/optimize", headers=AUTH, json={
                "user_id": "perf", "model_id": "p1"})
            assert (await r.json())["optimized"]
    run(go())


def test_x_api_key_header(client_factory):
    async def go():
        async with client_factory() as client:
            r = await client.get("/vectors/count",
                                 params={"user_id": "x", "model_id": "y"},
                                 headers={"X-API-Key": API_KEY})
            assert r.status == 404  # authorized; store just doesn't exist
            r = await client.get("/vectors/count",
                                 params={"user_id": "x", "model_id": "y"},
                                 headers={"X-API-Key": "wrong"})
            assert r.status == 401
    run(go())


def test_jwt_roundtrip():
    from tpu_vector_db_torch.security.auth import create_jwt, verify_jwt
    token = create_jwt({"sub": "user1", "tier": "premium"})
    payload = verify_jwt(token)
    assert payload["sub"] == "user1"
    assert verify_jwt(token + "x") is None
    expired = create_jwt({"sub": "u"}, expires_in_s=-10)
    assert verify_jwt(expired) is None


def test_create_ivf_store_via_rest(client_factory, rng):
    """index_type=ivf provisions the IVF family end-to-end through the
    admin route (api/routes/admin.py) — ref parity plus: the reference
    only exposed hnsw/flat (api/routes/admin.py vs ref main.py)."""
    async def go():
        async with client_factory() as client:
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "ivy", "model_id": "m1", "dimension": 32,
                "index_type": "ivf",
                "ann_params": {"min_rows": 0, "nprobe": 16,
                               "n_clusters": 4, "bucket_rows": 64,
                               "self_check": False}})
            assert r.status == 201

            vectors = rng.standard_normal((200, 32)).astype(np.float32)
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "ivy", "model_id": "m1",
                "vectors": vectors.tolist()})
            assert r.status == 200

            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "ivy", "model_id": "m1",
                "query": vectors[3].tolist(), "k": 3})
            assert r.status == 200
            body = await r.json()
            assert body["results"][0]["index"] == 3

            r = await client.get("/admin/store/stats",
                                 params={"user_id": "ivy",
                                         "model_id": "m1"},
                                 headers=ADMIN)
            stats = await r.json()
            assert stats.get("index", {}).get("type", "ivf") in (
                "ivf", "flat")
    run(go())


def test_query_coalescing(client_factory, rng, monkeypatch):
    """Concurrent single-vector queries fold into shared device batches
    (service/batcher.py) without changing any result."""
    async def go():
        async with client_factory() as client:
            app = client.server.app
            from tpu_vector_db_torch.service.batcher import QueryCoalescer
            app["coalescer"] = QueryCoalescer(app["manager"],
                                              window_ms=20, max_batch=32)
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "co", "model_id": "m1", "dimension": 32})
            assert r.status == 201
            vectors = rng.standard_normal((64, 32)).astype(np.float32)
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "co", "model_id": "m1",
                "vectors": vectors.tolist()})
            assert r.status == 200

            calls = []
            orig = app["manager"].batch_query_async

            async def counting(*a, **kw):
                calls.append(len(a[2]))
                return await orig(*a, **kw)

            monkeypatch.setattr(app["manager"], "batch_query_async",
                                counting)

            async def one(i):
                r = await client.post("/vectors/query", headers=AUTH, json={
                    "user_id": "co", "model_id": "m1",
                    "query": vectors[i].tolist(), "k": 1})
                assert r.status == 200
                body = await r.json()
                return body["results"][0]["index"]

            results = await asyncio.gather(*[one(i) for i in range(16)])
            assert list(results) == list(range(16))  # each finds itself
            assert sum(calls) == 16
            assert len(calls) < 16, f"no coalescing happened: {calls}"
            assert app["coalescer"].coalesced > 0
    run(go())


def test_coalescer_isolates_malformed_vectors(client_factory, rng):
    """A wrong-dimension query must fail ALONE, not poison concurrent
    well-formed requests sharing its coalescing window (review finding)."""
    async def go():
        async with client_factory() as client:
            app = client.server.app
            from tpu_vector_db_torch.service.batcher import QueryCoalescer
            app["coalescer"] = QueryCoalescer(app["manager"],
                                              window_ms=30, max_batch=32)
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "mix", "model_id": "m1", "dimension": 16})
            assert r.status == 201
            vectors = rng.standard_normal((8, 16)).astype(np.float32)
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "mix", "model_id": "m1",
                "vectors": vectors.tolist()})
            assert r.status == 200

            async def good(i):
                r = await client.post("/vectors/query", headers=AUTH, json={
                    "user_id": "mix", "model_id": "m1",
                    "query": vectors[i].tolist(), "k": 1})
                return r.status, (await r.json())

            async def bad():
                r = await client.post("/vectors/query", headers=AUTH, json={
                    "user_id": "mix", "model_id": "m1",
                    "query": [0.0] * 24, "k": 1})  # wrong dimension
                return r.status, (await r.json())

            results = await asyncio.gather(good(0), bad(), good(1))
            assert results[0][0] == 200
            assert results[0][1]["results"][0]["index"] == 0
            assert results[1][0] == 400
            assert results[2][0] == 200
            assert results[2][1]["results"][0]["index"] == 1
    run(go())


def test_capacity_dtype_store_via_rest(client_factory, rng):
    """int8/int4 capacity modes are creatable and servable through the
    REST surface; invalid combos 400 (store/config.py cross-validation)."""
    async def go():
        async with client_factory() as client:
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "u", "model_id": "cap4", "dimension": 256,
                "metric": "cosine", "storage_dtype": "int4"})
            assert r.status == 201, await r.text()
            vecs = rng.standard_normal((50, 256)).astype("float32")
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "u", "model_id": "cap4",
                "vectors": vecs.tolist(),
                "metadata": [{"i": i} for i in range(50)]})
            assert r.status == 200, await r.text()
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "u", "model_id": "cap4",
                "query": vecs[7].tolist(), "k": 3})
            assert r.status == 200
            body = await r.json()
            assert body["results"][0]["metadata"]["i"] == 7
            r = await client.get("/vectors/stats",
                                 params={"user_id": "u",
                                         "model_id": "cap4"},
                                 headers=AUTH)
            assert (await r.json())["storage_dtype"] == "int4"

            # euclidean + int4 must 400 (quantizer needs unit-norm rows)
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "u", "model_id": "bad", "dimension": 64,
                "metric": "euclidean", "storage_dtype": "int4"})
            assert r.status == 400, await r.text()

            # int8 + gather-layout IVF over REST (r3): quantized capacity
            # stores accept index_type=ivf and serve probed queries
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "u", "model_id": "cap8ivf", "dimension": 64,
                "metric": "cosine", "storage_dtype": "int8",
                "index_type": "ivf",
                "ann_params": {"min_rows": 0, "n_clusters": 4,
                               "nprobe": 8, "bucket_rows": 64,
                               "self_check": False}})
            assert r.status == 201, await r.text()
            vecs8 = rng.standard_normal((300, 64)).astype("float32")
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "u", "model_id": "cap8ivf",
                "vectors": vecs8.tolist(),
                "metadata": [{"i": i} for i in range(300)]})
            assert r.status == 200, await r.text()
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "u", "model_id": "cap8ivf",
                "query": vecs8[11].tolist(), "k": 3})
            assert r.status == 200
            body = await r.json()
            assert body["results"][0]["metadata"]["i"] == 11
            r = await client.get("/vectors/stats",
                                 params={"user_id": "u",
                                         "model_id": "cap8ivf"},
                                 headers=AUTH)
            stats = await r.json()
            assert stats["index_type"] == "ivf"

            # beam graph on quantized rows still 400s
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "u", "model_id": "bad2", "dimension": 64,
                "metric": "cosine", "storage_dtype": "int8",
                "index_type": "hnsw"})
            assert r.status == 400, await r.text()
    run(go())


def test_lazy_add_infers_dimension(client_factory, rng):
    """POST /vectors/add to a nonexistent store must lazily create it at
    the PAYLOAD's dimension — creating at the 384 default failed the add
    on dimension mismatch while leaving a phantom store that turned later
    /admin/create_store into a 409 (review finding)."""
    async def go():
        async with client_factory() as client:
            vecs = rng.standard_normal((5, 64)).astype("float32")
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "lazy", "model_id": "m64",
                "vectors": vecs.tolist(),
                "metadata": [{} for _ in range(5)]})
            assert r.status == 200, await r.text()
            r = await client.get("/vectors/stats",
                                 params={"user_id": "lazy",
                                         "model_id": "m64"},
                                 headers=AUTH)
            stats = await r.json()
            assert stats["dimension"] == 64
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "lazy", "model_id": "m64",
                "query": vecs[2].tolist(), "k": 1})
            assert (await r.json())["results"][0]["index"] == 2
    run(go())


def test_webhook_url_validation():
    """SSRF guard: callback_url must be http(s) and must not resolve to
    private/loopback/link-local space (review finding)."""
    import pytest as _pytest
    from aiohttp import web as _web

    from tpu_vector_db_torch.api.routes.batch import validate_callback_url

    for bad in ("ftp://example.com/x", "http://127.0.0.1/steal",
                "http://localhost:8000/admin", "http://169.254.169.254/t",
                "http://10.0.0.1/x", "not-a-url"):
        with _pytest.raises(_web.HTTPBadRequest):
            validate_callback_url(bad)
    import os
    os.environ["VECTOR_DB_WEBHOOK_ALLOW_PRIVATE"] = "1"
    try:
        validate_callback_url("http://127.0.0.1:9/ok")  # explicit opt-in
    finally:
        del os.environ["VECTOR_DB_WEBHOOK_ALLOW_PRIVATE"]


def test_health_checker_caches_device_probe():
    """/health is unauthenticated: the device probe must be TTL-cached so
    a request loop cannot saturate the accelerator (review finding)."""
    from tpu_vector_db_torch.monitoring.health import HealthChecker

    hc = HealthChecker(cache_ttl_s=60.0)
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        return {"healthy": True}

    hc.register("probe", probe)
    hc.run_all()
    hc.run_all()
    hc.run_all()
    assert calls["n"] == 1


def test_delete_vectors_endpoint(client_factory, rng):
    async def go():
        async with client_factory() as client:
            vecs = rng.standard_normal((20, 32)).astype("float32")
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "d", "model_id": "m", "dimension": 32})
            assert r.status == 201
            r = await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "d", "model_id": "m", "vectors": vecs.tolist(),
                "metadata": [{"i": i} for i in range(20)]})
            assert r.status == 200
            r = await client.post("/vectors/delete", headers=AUTH, json={
                "user_id": "d", "model_id": "m", "indices": [3, 4]})
            assert r.status == 200
            body = await r.json()
            assert body == {"deleted": 2, "live": 18}
            r = await client.get("/vectors/count",
                                 params={"user_id": "d", "model_id": "m"},
                                 headers=AUTH)
            assert (await r.json())["count"] == 18
            r = await client.post("/vectors/query", headers=AUTH, json={
                "user_id": "d", "model_id": "m",
                "query": vecs[3].tolist(), "k": 5})
            got = [x["index"] for x in (await r.json())["results"]]
            assert 3 not in got and 4 not in got
            # empty indices -> 422; out-of-range -> 400
            r = await client.post("/vectors/delete", headers=AUTH, json={
                "user_id": "d", "model_id": "m", "indices": []})
            assert r.status == 422
            r = await client.post("/vectors/delete", headers=AUTH, json={
                "user_id": "d", "model_id": "m", "indices": [100]})
            assert r.status == 400
    run(go())


def test_get_vectors_by_id(client_factory, rng):
    async def go():
        async with client_factory() as client:
            vecs = rng.standard_normal((10, 16)).astype("float32")
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "g", "model_id": "m", "dimension": 16})
            assert r.status == 201
            await client.post("/vectors/add", headers=AUTH, json={
                "user_id": "g", "model_id": "m", "vectors": vecs.tolist(),
                "metadata": [{"i": i} for i in range(10)]})
            r = await client.get("/vectors/get", headers=AUTH,
                                 params={"user_id": "g", "model_id": "m",
                                         "ids": "2,5"})
            assert r.status == 200, await r.text()
            body = await r.json()
            assert body["ids"] == [2, 5]
            np.testing.assert_allclose(body["vectors"][0], vecs[2],
                                       atol=1e-6)
            assert body["metadata"][1] == {"i": 5}
            # deleted id -> 404
            await client.post("/vectors/delete", headers=AUTH, json={
                "user_id": "g", "model_id": "m", "indices": [5]})
            r = await client.get("/vectors/get", headers=AUTH,
                                 params={"user_id": "g", "model_id": "m",
                                         "ids": "5"})
            assert r.status == 404
            r = await client.get("/vectors/get", headers=AUTH,
                                 params={"user_id": "g", "model_id": "m",
                                         "ids": "abc"})
            assert r.status == 400
    run(go())


def test_create_store_over_hbm_budget_413(client_factory, monkeypatch):
    """expected_rows over the device budget -> clean 413 naming the
    capacity modes (store/config.py check_device_budget; r4 verdict 8)."""
    monkeypatch.setenv("VDB_HBM_BYTES", str(64 * 1024 ** 2))  # 64 MiB

    async def go():
        async with client_factory() as client:
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "big", "model_id": "m", "dimension": 768,
                "expected_rows": 50_000_000})
            assert r.status == 413
            body = await r.json()
            assert "int4" in body["error"]
            # within budget: created normally
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "big", "model_id": "m", "dimension": 768,
                "expected_rows": 10_000})
            assert r.status == 201
    run(go())


# ------------------------------------------------------- port-only cases

def test_beam_graph_store_501(client_factory, rng):
    """Beam-graph stores, which the port answered with a 501 until the
    graph was ported: ``beam_graph`` and its ``hnsw`` alias are created
    (201) as graph stores, filled and queried through the graph; on
    int8/int4 rows the graph stays the 400 of the config check, as in the
    JAX server."""
    async def go():
        async with client_factory() as client:
            vecs = rng.standard_normal((600, 32)).astype(np.float32)
            for itype in ("beam_graph", "hnsw"):
                who = {"user_id": "bg", "model_id": itype}
                r = await client.post("/admin/create_store", headers=ADMIN,
                                      json={**who, "dimension": 32,
                                            "index_type": itype,
                                            "ann_params": {
                                                "M": 8,
                                                "ef_construction": 64}})
                assert r.status == 201, await r.text()
                assert (await r.json())["index_type_requested"] == \
                    "beam_graph"
                r = await client.post("/vectors/add", headers=AUTH, json={
                    **who, "vectors": vecs.tolist(),
                    "metadata": [{"i": i} for i in range(600)]})
                assert r.status == 200, await r.text()
                r = await client.get("/vectors/stats", params=who,
                                     headers=AUTH)
                assert (await r.json())["index_type"] == "beam_graph"
                r = await client.post("/vectors/batch_query", headers=AUTH,
                                      json={**who, "k": 3,
                                            "queries": vecs[[5, 321]].tolist()})
                assert r.status == 200
                top = [row[0] for row in (await r.json())["results"]]
                assert [t["index"] for t in top] == [5, 321]
                assert top[0]["metadata"] == {"i": 5}
                assert top[0]["similarity"] > 0.999
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "bg", "model_id": "q", "dimension": 64,
                "storage_dtype": "int4", "index_type": "beam_graph"})
            assert r.status == 400
            # nothing was left behind: the name is free
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "bg", "model_id": "q", "dimension": 32})
            assert r.status == 201
    run(go())


def test_create_app_without_cuda_refuses(monkeypatch, tmp_path):
    """Asked for the card (the default) where there is none, the app is
    not made: it raises and does not start on the CPU."""
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    monkeypatch.delenv("VDB_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_app()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_app(manager=VectorStoreManager(base_path=tmp_path))
    monkeypatch.setenv("VDB_FORCE_CPU", "1")
    app = create_app(manager=VectorStoreManager(base_path=tmp_path,
                                                device="cpu"))
    assert app["device"] == "cpu"
    app["manager"].shutdown()


def test_imports_touch_no_cuda():
    """The library, the service layer and the app import on a machine
    without a card, touch no CUDA and import no JAX."""
    code = (
        "import sys, torch\n"
        "import tpu_vector_db_torch, tpu_vector_db_torch.service\n"
        "import tpu_vector_db_torch.api.app, tpu_vector_db_torch.api.main\n"
        "import tpu_vector_db_torch.sdk\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tpu_vector_db' or m.startswith('tpu_vector_db.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.gpu
def test_coalesced_queries_on_card(tmp_path, rng):
    """On the card: 32 concurrent coalesced queries over 8192 x 256 rows
    answer as the store's own batch_query does, and /health names the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_vector_db_torch.service.batcher import QueryCoalescer

    async def go():
        async with make_client(tmp_path, "cuda") as client:
            app = client.server.app
            app["coalescer"] = QueryCoalescer(app["manager"], window_ms=20,
                                              max_batch=64)
            r = await client.get("/health")
            assert r.status == 200
            dev = (await r.json())["checks"]["device"]
            assert dev["device_name"] == torch.cuda.get_device_name(0)
            r = await client.post("/admin/create_store", headers=ADMIN, json={
                "user_id": "card", "model_id": "m", "dimension": 256})
            assert r.status == 201
            rows = rng.standard_normal((8192, 256)).astype(np.float32)
            for start in range(0, 8192, 2048):
                r = await client.post("/vectors/add", headers=AUTH, json={
                    "user_id": "card", "model_id": "m",
                    "vectors": rows[start:start + 2048].tolist()})
                assert r.status == 200
            qs = rows[:32] + 0.1 * rng.standard_normal((32, 256)).astype(
                np.float32)

            # the admin key's tier allows 64 queries in flight, the
            # service key's 16
            async def one(i):
                r = await client.post("/vectors/query", headers=ADMIN, json={
                    "user_id": "card", "model_id": "m",
                    "query": qs[i].tolist(), "k": 10})
                assert r.status == 200
                return (await r.json())["results"]

            got = await asyncio.gather(*[one(i) for i in range(32)])
            assert app["coalescer"].batches < 32
            store = app["manager"].get_store("card", "m", create=False)
            direct = store.batch_query(qs, k=10)
            for res, (ids, scores, _) in zip(got, direct):
                assert_same_results(res, ids, scores)
    run(go())


def assert_same_results(results: list[dict], ids, scores,
                        tol: float = 1e-5) -> None:
    """REST results against a store's (ids, scores): similarities within
    tol, ids equal where the score is not within tol of another one."""
    got_sim = np.array([r["similarity"] for r in results])
    np.testing.assert_allclose(got_sim, np.round(scores, 6), atol=tol)
    for pos, r in enumerate(results):
        near = np.abs(np.asarray(scores) - scores[pos]) <= 2 * tol
        if near.sum() == 1:
            assert r["index"] == ids[pos]
