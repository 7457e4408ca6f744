"""Vector CRUD + query endpoints.

Parity with reference api/routes/vectors.py:163-467 (/vectors/add, /query,
/batch_query, /count, /stats, /health, /benchmark) — with /batch_query
actually working (the reference called a store method that didn't exist,
SURVEY.md §2.1).
"""

from __future__ import annotations

import time

import numpy as np
from aiohttp import web

from tpu_vector_db_torch.api.models import (
    BatchQueryRequest, BenchmarkRequest, VectorAddRequest,
    VectorDeleteRequest, VectorQueryRequest)
from tpu_vector_db_torch.api.routes._helpers import (
    format_results, parse_model, require_api_key)
from tpu_vector_db_torch.monitoring import (
    record_vector_addition, record_vector_query, tracing)


def register(app: web.Application) -> None:
    app.router.add_post("/vectors/add", add_vectors)
    app.router.add_post("/vectors/delete", delete_vectors)
    app.router.add_post("/vectors/query", query_vectors)
    app.router.add_post("/vectors/batch_query", batch_query_vectors)
    app.router.add_get("/vectors/get", get_vectors)
    app.router.add_get("/vectors/count", vector_count)
    app.router.add_get("/vectors/stats", vector_stats)
    app.router.add_get("/vectors/health", vectors_health)
    app.router.add_post("/vectors/benchmark", vectors_benchmark)


@require_api_key
async def add_vectors(request: web.Request) -> web.Response:
    body = await parse_model(request, VectorAddRequest)
    manager = request.app["manager"]
    t0 = time.perf_counter()
    arr = np.asarray(body.vectors, dtype=np.float32)
    result = await manager.add_vectors_async(
        body.user_id, body.model_id, arr, body.metadata)
    dt = time.perf_counter() - t0
    record_vector_addition(result["added"], dt)
    return web.json_response({
        **result, "duration_ms": round(dt * 1e3, 2),
        "vectors_per_second": round(result["added"] / max(dt, 1e-9), 1),
    })


@require_api_key
async def delete_vectors(request: web.Request) -> web.Response:
    """Tombstone rows by id (ids stay stable; space reclaims on
    /admin/optimize_store-style compact). Capability beyond the
    reference — it had no per-vector deletion at all."""
    body = await parse_model(request, VectorDeleteRequest)
    manager = request.app["manager"]
    result = await manager.delete_vectors_async(
        body.user_id, body.model_id, body.indices)
    return web.json_response(result)


@require_api_key
async def query_vectors(request: web.Request) -> web.Response:
    body = await parse_model(request, VectorQueryRequest,
                             vectors=("query", 1))
    manager = request.app["manager"]
    coalescer = request.app.get("coalescer")
    t0 = time.perf_counter()
    if coalescer is not None:
        # concurrent same-store queries fold into one device batch
        # (service/batcher.py) — the batch-1 kernel floor becomes the
        # batch-64 roofline under load
        indices, scores, metadata = await coalescer.query(
            body.user_id, body.model_id,
            np.asarray(body.query, np.float32), k=body.k,
            filter_metadata=body.filter_metadata, use_ann=body.use_ann,
            rerank=body.rerank)
    else:
        indices, scores, metadata = await manager.query_async(
            body.user_id, body.model_id,
            np.asarray(body.query, np.float32), k=body.k,
            filter_metadata=body.filter_metadata, use_ann=body.use_ann,
            rerank=body.rerank)
    dt = time.perf_counter() - t0
    record_vector_query(dt)
    store = manager.get_store(body.user_id, body.model_id, create=False)
    with tracing.span("api.encode", host_only=True):
        return web.json_response({
            "results": format_results(indices, scores, metadata,
                                      store.metric),
            "query_time_ms": round(dt * 1e3, 3),
            "store_count": len(store),
            "metric": store.metric,
        })


@require_api_key
async def batch_query_vectors(request: web.Request) -> web.Response:
    body = await parse_model(request, BatchQueryRequest,
                             vectors=("queries", 2))
    manager = request.app["manager"]
    t0 = time.perf_counter()
    batches = await manager.batch_query_async(
        body.user_id, body.model_id, np.asarray(body.queries, np.float32),
        k=body.k, filter_metadata=body.filter_metadata, use_ann=body.use_ann,
        rerank=body.rerank)
    dt = time.perf_counter() - t0
    record_vector_query(dt)
    store = manager.get_store(body.user_id, body.model_id, create=False)
    return web.json_response({
        "results": [format_results(i, s, m, store.metric)
                    for (i, s, m) in batches],
        "query_time_ms": round(dt * 1e3, 3),
        "queries": len(batches),
        "qps": round(len(batches) / max(dt, 1e-9), 1),
        "store_count": len(store),
        "metric": store.metric,
    })


@require_api_key
async def get_vectors(request: web.Request) -> web.Response:
    """Fetch vectors + metadata by id (?user_id=&model_id=&ids=1,2,3).
    Standard vector-DB surface the reference lacked; tombstoned ids 404."""
    q = request.rel_url.query
    user_id, model_id = q.get("user_id"), q.get("model_id")
    if not user_id or not model_id or not q.get("ids"):
        raise web.HTTPBadRequest(reason="user_id, model_id, ids required")
    try:
        ids = [int(s) for s in q["ids"].split(",") if s.strip()]
    except ValueError:
        raise web.HTTPBadRequest(reason="ids must be comma-separated ints")
    if not ids or len(ids) > 1000:
        raise web.HTTPBadRequest(reason="1..1000 ids per request")
    import asyncio
    manager = request.app["manager"]
    store = manager.get_store(user_id, model_id, create=False)

    def fetch():
        # store methods validate (tombstoned/out-of-range -> KeyError,
        # mapped to 404 by the error middleware); runs on a WORKER so the
        # store lock — held for minutes during device compiles — cannot
        # stall the event loop (review finding)
        return store.get_vectors(ids), store.get_metadata(ids)

    vecs, metas = await asyncio.get_running_loop().run_in_executor(
        manager.executor, fetch)
    return web.json_response({
        "ids": ids,
        "vectors": vecs.tolist(),
        "metadata": metas,
    })


@require_api_key
async def vector_count(request: web.Request) -> web.Response:
    user_id = request.query.get("user_id", "")
    model_id = request.query.get("model_id", "")
    store = request.app["manager"].get_store(user_id, model_id, create=False)
    return web.json_response({"user_id": user_id, "model_id": model_id,
                              "count": len(store)})


@require_api_key
async def vector_stats(request: web.Request) -> web.Response:
    user_id = request.query.get("user_id", "")
    model_id = request.query.get("model_id", "")
    store = request.app["manager"].get_store(user_id, model_id, create=False)
    return web.json_response({
        "user_id": user_id, "model_id": model_id, **store.get_stats()})


async def vectors_health(request: web.Request) -> web.Response:
    stats = request.app["manager"].get_stats()
    return web.json_response({
        "status": "healthy",
        "loaded_stores": stats["loaded_stores"],
        "total_vectors": stats["total_vectors"],
        "total_memory_mb": stats["total_memory_mb"],
    })


@require_api_key
async def vectors_benchmark(request: web.Request) -> web.Response:
    """In-process add+query micro-benchmark (reference :390-467)."""
    body = await parse_model(request, BenchmarkRequest)
    manager = request.app["manager"]
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal(
        (body.num_vectors, body.dimension)).astype(np.float32)

    from tpu_vector_db_torch.store.config import VectorStoreConfig
    user, model = body.user_id, f"{body.model_id}_bench_{body.dimension}"
    store = manager.get_store(user, model, VectorStoreConfig(
        dimension=body.dimension, persist_mode="off"))
    store.clear()

    t0 = time.perf_counter()
    await manager.add_vectors_async(user, model, vectors)
    add_dt = time.perf_counter() - t0

    queries = vectors[rng.integers(0, body.num_vectors, body.num_queries)]
    store.warmup()
    t0 = time.perf_counter()
    await manager.batch_query_async(user, model, queries, k=body.k)
    query_dt = time.perf_counter() - t0

    store.clear()
    return web.json_response({
        "config": body.model_dump(),
        "ingest": {"vectors_per_second": round(body.num_vectors / add_dt, 1),
                   "duration_ms": round(add_dt * 1e3, 1)},
        "query": {"qps": round(body.num_queries / query_dt, 1),
                  "avg_latency_ms": round(query_dt / body.num_queries * 1e3, 3),
                  "duration_ms": round(query_dt * 1e3, 1)},
    })
