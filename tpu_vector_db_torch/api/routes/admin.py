"""Admin endpoints: store lifecycle + system stats.

Parity with reference api/routes/admin.py:25-233 (/admin/create_store 409 on
exists, /admin/store DELETE refusing non-empty without force,
/admin/store/stats, /admin/list_stores, /admin/optimize_store as a
background task — here optimize actually exists on the store —
/admin/system_stats).
"""

from __future__ import annotations

import asyncio

from aiohttp import web

from tpu_vector_db_torch.api.models import (
    CreateStoreRequest, DeleteStoreRequest, OptimizeStoreRequest)
from tpu_vector_db_torch.api.routes._helpers import (
    accelerator, parse_model, require_admin_key)
from tpu_vector_db_torch.store.config import VectorStoreConfig


def register(app: web.Application) -> None:
    app.router.add_post("/admin/create_store", create_store)
    app.router.add_delete("/admin/store", delete_store)
    app.router.add_get("/admin/store/stats", store_stats)
    app.router.add_get("/admin/list_stores", list_stores)
    app.router.add_post("/admin/optimize_store", optimize_store)
    app.router.add_get("/admin/system_stats", system_stats)


@require_admin_key
async def create_store(request: web.Request) -> web.Response:
    body = await parse_model(request, CreateStoreRequest)
    manager = request.app["manager"]
    ann_params = dict(body.ann_params or VectorStoreConfig().ann_params)
    itype = body.index_type.value
    if itype in ("beam_graph", "hnsw"):
        # the hnsw alias must pin the graph family explicitly — the store's
        # in-config default is now 'auto' (flat/IVF routing)
        ann_params.setdefault("index_type", "beam_graph")
    elif itype in ("ivf", "auto"):
        ann_params.setdefault("index_type", itype)
    cfg = VectorStoreConfig(
        dimension=body.dimension,
        metric=body.metric.value,
        enable_ann=(body.index_type.value in
                    ("beam_graph", "hnsw", "ivf", "auto")),
        storage_dtype=body.storage_dtype,
        ann_params=ann_params,
    )
    if body.expected_rows:
        # creation-time HBM guard: the error middleware maps
        # StoreCapacityError to a 413 naming the int8/int4 capacity
        # modes and the max feasible rows (store/config.py)
        cfg.check_device_budget(body.expected_rows, device=manager.device)
    try:
        store = manager.create_store(body.user_id, body.model_id, cfg)
    except FileExistsError:
        raise web.HTTPConflict(
            reason=f"store {body.user_id}/{body.model_id} already exists")
    return web.json_response(
        {"created": True, "user_id": body.user_id, "model_id": body.model_id,
         **store.get_stats()},
        status=201)


@require_admin_key
async def delete_store(request: web.Request) -> web.Response:
    body = await parse_model(request, DeleteStoreRequest)
    try:
        request.app["manager"].delete_store(
            body.user_id, body.model_id, force=body.force)
    except ValueError as exc:
        raise web.HTTPConflict(reason=str(exc))
    return web.json_response({"deleted": True, "user_id": body.user_id,
                              "model_id": body.model_id})


@require_admin_key
async def store_stats(request: web.Request) -> web.Response:
    user_id = request.query.get("user_id", "")
    model_id = request.query.get("model_id", "")
    store = request.app["manager"].get_store(user_id, model_id, create=False)
    return web.json_response({"user_id": user_id, "model_id": model_id,
                              **store.get_stats()})


@require_admin_key
async def list_stores(request: web.Request) -> web.Response:
    user_id = request.query.get("user_id")
    stores = request.app["manager"].list_stores(user_id)
    return web.json_response({"stores": stores, "count": len(stores)})


@require_admin_key
async def optimize_store(request: web.Request) -> web.Response:
    """Runs store.optimize() in the worker pool as a background task and
    returns immediately (reference used FastAPI BackgroundTasks,
    admin.py:171-192 — against a method that didn't exist)."""
    body = await parse_model(request, OptimizeStoreRequest)
    manager = request.app["manager"]
    store = manager.get_store(body.user_id, body.model_id, create=False)
    loop = asyncio.get_running_loop()
    loop.run_in_executor(manager.executor, store.optimize)
    return web.json_response({
        "scheduled": True, "user_id": body.user_id,
        "model_id": body.model_id}, status=202)


@require_admin_key
async def system_stats(request: web.Request) -> web.Response:
    import psutil
    manager_stats = request.app["manager"].get_stats()
    vm = psutil.virtual_memory()
    body = {
        "stores": manager_stats,
        "system": {
            "cpu_percent": psutil.cpu_percent(),
            "memory_percent": vm.percent,
            "memory_available_gb": round(vm.available / 2**30, 2),
            "disk_percent": psutil.disk_usage("/").percent,
        },
    }
    acc = accelerator(request.app["device"])
    body["accelerator"] = {"backend": acc["backend"],
                           "device_count": acc["device_count"]}
    return web.json_response(body)
