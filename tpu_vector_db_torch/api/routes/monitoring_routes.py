"""Monitoring endpoints.

Parity with reference api/routes/monitoring.py:53-164 (/monitoring/health,
/metrics, /status, /stores) plus /monitoring/prometheus exposition — the
registry the reference built but never mounted (SURVEY.md §2.1).
"""

from __future__ import annotations

import os
import platform
import time

from aiohttp import web

from tpu_vector_db_torch.api.routes._helpers import (
    accelerator, require_api_key)
from tpu_vector_db_torch.monitoring import get_registry


def register(app: web.Application) -> None:
    app.router.add_get("/monitoring/health", monitoring_health)
    app.router.add_get("/monitoring/metrics", monitoring_metrics)
    app.router.add_get("/monitoring/prometheus", prometheus)
    app.router.add_get("/monitoring/status", monitoring_status)
    app.router.add_get("/monitoring/stores", monitoring_stores)


async def monitoring_health(request: web.Request) -> web.Response:
    checks = request.app["health_checker"].run_all()
    return web.json_response(checks,
                             status=200 if checks["status"] != "unhealthy"
                             else 503)


@require_api_key
async def monitoring_metrics(request: web.Request) -> web.Response:
    import psutil
    reg = get_registry()
    reg.sample_system()
    proc = psutil.Process()
    return web.json_response({
        "summary": reg.summary(),
        "system": {
            "cpu_percent": psutil.cpu_percent(),
            "memory_percent": psutil.virtual_memory().percent,
            "disk_percent": psutil.disk_usage("/").percent,
            "process_rss_mb": round(proc.memory_info().rss / 2**20, 1),
            "process_threads": proc.num_threads(),
        },
        "timestamp": time.time(),
    })


@require_api_key
async def prometheus(request: web.Request) -> web.Response:
    reg = get_registry()
    reg.sample_system()
    return web.Response(text=reg.get_prometheus_format(),
                        content_type="text/plain")


@require_api_key
async def monitoring_status(request: web.Request) -> web.Response:
    stats = request.app["manager"].get_stats()
    acc = accelerator(request.app["device"])
    return web.json_response({
        "platform": platform.platform(),
        "environment": os.environ.get("ENVIRONMENT", "development"),
        "backend": acc["backend"],
        "device_count": acc["device_count"],
        "uptime_s": round(time.time() - request.app["started_at"], 1),
        "stores": {"loaded": stats["loaded_stores"],
                   "total_vectors": stats["total_vectors"],
                   "total_memory_mb": stats["total_memory_mb"]},
        "resilience": request.app["manager"].errors.get_error_stats(),
    })


@require_api_key
async def monitoring_stores(request: web.Request) -> web.Response:
    stores = request.app["manager"].list_stores()
    return web.json_response({"stores": stores, "count": len(stores),
                              "timestamp": time.time()})
