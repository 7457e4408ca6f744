"""Root/info endpoints: banner, /health, /system/info, /config, /debug/*.

Parity with reference main.py:211-363. The port of
``tpu_vector_db.api.routes.root``: device facts come from torch, and
``/debug/profile`` records a ``torch.profiler`` trace and the program's
spans of the same period.
"""

from __future__ import annotations

import json
import os
import platform
import time

import torch
from aiohttp import web

from tpu_vector_db_torch.api.routes._helpers import accelerator
from tpu_vector_db_torch.monitoring import get_registry, tracing


def register(app: web.Application) -> None:
    app.router.add_get("/", banner)
    app.router.add_get("/health", health)
    app.router.add_get("/system/info", system_info)
    app.router.add_get("/config", config)
    if os.environ.get("ENVIRONMENT", "development") == "development":
        app.router.add_get("/debug/routes", debug_routes)
        app.router.add_get("/debug/device", debug_device)
        app.router.add_post("/debug/profile", debug_profile)


async def banner(request: web.Request) -> web.Response:
    return web.json_response({
        "service": "tpu-vector-db",
        "version": request.app["version"],
        "description": "vector index-and-query engine on PyTorch and CUDA",
        "features": [
            "flat exact search (cosine / euclidean / dot)",
            "IVF ANN index (k-means buckets, probe-scan kernel)",
            "beam-graph ANN index (batched beam search, incremental "
            "inserts, native C++ builder)",
            "multi-tenant stores with metadata filtering",
            "bf16 storage, int8/int4 capacity modes",
            "query coalescing into batched scans",
            "batch API with progress + SSE",
            "tiered rate limiting, metrics, structured logging",
        ],
        "docs": {"health": "/health", "metrics": "/monitoring/prometheus"},
    })


async def health(request: web.Request) -> web.Response:
    import asyncio
    if request.app["manager"].peer_lost:
        # don't touch the worker pool: a stalled collective may hold one
        # of its threads; report the degradation at once
        return web.json_response(
            {"status": "unhealthy", "peer_lost": True,
             "timestamp": time.time(),
             "error": "peer process lost; restart the serving group"},
            status=503)
    # the device check blocks on the accelerator — keep it off the event
    # loop (the TTL cache inside run_all bounds how often it runs at all)
    loop = asyncio.get_running_loop()
    checks = await loop.run_in_executor(
        request.app["manager"].executor,
        request.app["health_checker"].run_all)
    stats = request.app["manager"].get_stats()
    handler_health = request.app["manager"].errors.health_check()
    http = get_registry().histogram("http_request_duration_seconds").snapshot()
    body = {
        "status": checks["status"],
        "timestamp": time.time(),
        "uptime_s": round(time.time() - request.app["started_at"], 1),
        "checks": checks["checks"],
        "stores": {"loaded": stats["loaded_stores"],
                   "total_vectors": stats["total_vectors"]},
        "requests": {
            "total": http["count"],
            "avg_ms": round(http["sum"] / http["count"] * 1e3, 2)
            if http["count"] else 0.0,
        },
        "resilience": {"score": handler_health["score"],
                       "status": handler_health["status"]},
    }
    status_code = 200 if checks["status"] != "unhealthy" else 503
    return web.json_response(body, status=status_code)


async def system_info(request: web.Request) -> web.Response:
    import psutil
    vm = psutil.virtual_memory()
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
        "memory": {"total_gb": round(vm.total / 2**30, 2),
                   "available_gb": round(vm.available / 2**30, 2),
                   "percent": vm.percent},
    }
    info["accelerator"] = accelerator(request.app["device"])
    return web.json_response(info)


async def config(request: web.Request) -> web.Response:
    acc = accelerator(request.app["device"])
    return web.json_response({
        "environment": os.environ.get("ENVIRONMENT", "development"),
        "backend": acc["backend"],
        "device_count": acc["device_count"],
        "features": {
            "ann_index": True,
            "ann_index_types": ["ivf", "beam_graph"],
            "batch_api": True,
            "sse_progress": True,
            "rate_limiting": True,
            "metrics": True,
            "sharding": False,
        },
        "limits": {"max_k": 1000, "max_dimension": 8192,
                   "max_upload_mb": 512},
    })


async def debug_routes(request: web.Request) -> web.Response:
    routes = [{"method": r.method, "path": r.resource.canonical}
              for r in request.app.router.routes()
              if r.resource is not None]
    return web.json_response({"routes": routes, "count": len(routes)})


async def debug_profile(request: web.Request) -> web.Response:
    """Capture a torch.profiler trace of a probe workload (dev only).

    The reference had no tracer at all (SURVEY.md §5 — wall-clock timers
    only); this writes a Chrome trace (host ops and, on a CUDA device, its
    kernels) viewable in Perfetto or chrome://tracing, and beside it the
    program's own spans of the profiled period (``monitoring/tracing.py``:
    every thread's api, coalescer, manager, store and index stages) as a
    second Chrome trace on the same time base. Body:
    {"duration_ms": 500, "trace_dir": "/tmp/vdb_trace"}.
    """
    from torch.profiler import ProfilerActivity, profile
    try:
        payload = await request.json()
    except Exception:  # noqa: BLE001
        payload = {}
    trace_dir = payload.get("trace_dir", "/tmp/vdb_trace")
    duration_s = min(float(payload.get("duration_ms", 500)), 10_000) / 1e3
    dev = torch.device(request.app["device"])
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def _trace():  # device-blocking: run on a worker, not the event loop
        x = torch.ones((1024, 1024), device=dev)
        t0 = time.perf_counter_ns()
        with profile(activities=activities) as prof:
            deadline = time.time() + duration_s
            while time.time() < deadline:
                x = x @ x * 1e-3
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        os.makedirs(trace_dir, exist_ok=True)
        stamp = time.time_ns()
        path = os.path.join(trace_dir, f"trace_{stamp}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            base_ns = json.load(f).get("baseTimeNanoseconds", 0)
        spans_path = os.path.join(trace_dir, f"spans_{stamp}.json")
        n = tracing.export_chrome(spans_path, t0, t1, base_ns)
        return path, spans_path, n

    import asyncio
    path, spans_path, n_spans = await asyncio.get_running_loop(
        ).run_in_executor(request.app["manager"].executor, _trace)
    return web.json_response({"trace_dir": trace_dir,
                              "trace": path,
                              "spans": spans_path,
                              "span_count": n_spans,
                              "duration_s": duration_s,
                              "view": "open <trace> and <spans> in "
                                      "ui.perfetto.dev"})


async def debug_device(request: web.Request) -> web.Response:
    import asyncio
    dev = torch.device(request.app["device"])
    t0 = time.perf_counter()

    def _probe():
        x = torch.ones((256, 256), device=dev)
        x = x @ x
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    await asyncio.get_running_loop().run_in_executor(
        request.app["manager"].executor, _probe)
    info = accelerator(request.app["device"])
    return web.json_response({
        "backend": info["backend"],
        "devices": info["devices"],
        "matmul_probe_ms": round((time.perf_counter() - t0) * 1e3, 2),
    })
