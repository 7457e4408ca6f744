"""Performance endpoints.

Parity with reference api/routes/performance.py:37-220 (/performance/health,
/warmup, /benchmark, /optimize, /stats) — without the reference's duplicate
unauthenticated /performance/health registration (:98, flagged in SURVEY.md
§2.1), and with warmup/optimize hitting real store methods.
"""

from __future__ import annotations

import asyncio
import time

import torch
from aiohttp import web

from tpu_vector_db_torch.api.routes._helpers import require_api_key
from tpu_vector_db_torch.ops.monitor import performance_monitor


def register(app: web.Application) -> None:
    app.router.add_get("/performance/health", perf_health)
    app.router.add_post("/performance/warmup", warmup)
    app.router.add_post("/performance/benchmark", benchmark)
    app.router.add_post("/performance/optimize", optimize)
    app.router.add_get("/performance/stats", stats)


@require_api_key
async def perf_health(request: web.Request) -> web.Response:
    dev = torch.device(request.app["device"])
    t0 = time.perf_counter()
    x = torch.ones((512, 512), device=dev)
    x = torch.matmul(x, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return web.json_response({
        "status": "healthy",
        "backend": dev.type,
        "matmul_512_ms": round((time.perf_counter() - t0) * 1e3, 2),
    })


@require_api_key
async def warmup(request: web.Request) -> web.Response:
    """Compile the hot paths for one store, or all loaded stores."""
    try:
        payload = await request.json()
    except Exception:  # noqa: BLE001
        payload = {}
    manager = request.app["manager"]
    loop = asyncio.get_running_loop()
    if payload.get("user_id") and payload.get("model_id"):
        store = manager.get_store(payload["user_id"], payload["model_id"],
                                  create=False)
        result = await loop.run_in_executor(manager.executor, store.warmup)
        return web.json_response({"warmed": {f"{payload['user_id']}/"
                                             f"{payload['model_id']}": result}})
    result = await loop.run_in_executor(
        manager.executor, manager.warmup_all_stores)
    return web.json_response({"warmed": result})


@require_api_key
async def benchmark(request: web.Request) -> web.Response:
    from tpu_vector_db_torch.api.routes.vectors import vectors_benchmark
    return await vectors_benchmark.__wrapped__(request)  # shared impl


@require_api_key
async def optimize(request: web.Request) -> web.Response:
    payload = await request.json()
    manager = request.app["manager"]
    store = manager.get_store(payload["user_id"], payload["model_id"],
                              create=False)
    loop = asyncio.get_running_loop()
    result = await loop.run_in_executor(manager.executor, store.optimize)
    return web.json_response(result)


@require_api_key
async def stats(request: web.Request) -> web.Response:
    user_id = request.query.get("user_id")
    model_id = request.query.get("model_id")
    body = {"kernels": performance_monitor.get_stats()}
    coalescer = request.app.get("coalescer")
    if coalescer is not None:
        body["coalescer"] = coalescer.get_stats()
    if user_id and model_id:
        store = request.app["manager"].get_store(user_id, model_id,
                                                 create=False)
        body["store"] = store.get_stats()
    else:
        body["stores"] = request.app["manager"].get_stats()
    return web.json_response(body)
