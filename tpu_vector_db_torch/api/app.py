"""aiohttp application assembly.

Counterpart of the reference's ``main.py`` (FastAPI app, lifespan warmup,
CORS/GZip middleware, request tracking with rolling latency +
X-Response-Time, structured exception handlers, router mounting, dev/prod
entrypoints — reference main.py:64-427). Differences by design:

* aiohttp instead of FastAPI/uvicorn (asyncio-native, no ASGI layer);
* rate limiting, metrics, and structured logging are ATTACHED (the reference
  defined all three and wired none, SURVEY.md §2.1);
* there is no workers=1 constraint: device calls run in the manager's
  worker pool (reference main.py:395 pinned a single worker because MLX
  could not share the GPU).

The port of ``tpu_vector_db.api.app``: the app serves on ``device``
("cuda" unless the caller asks for the CPU, see ``core/runtime.py``),
checks that the device exists when it is made and runs a probe on it at
startup; a failed probe stops the startup. The error handler is the
manager's. Under multi-host serving (``VECTOR_DB_COORDINATOR``,
``VECTOR_DB_NUM_PROCESSES``, ``VECTOR_DB_PROCESS_ID``) the startup first
joins the gloo process group, which must form, and a lost peer becomes a
503 with ``"degraded": "peer_lost"``.
"""

from __future__ import annotations

import logging
import os
import time
import uuid

import torch
from aiohttp import web

from tpu_vector_db_torch import __version__
from tpu_vector_db_torch.api.middleware.rate_limiting import (
    ProductionRateLimiter, classify_operation, classify_tier)
from tpu_vector_db_torch.core.logging_config import request_context, setup_logging
from tpu_vector_db_torch.core.runtime import setup_runtime
from tpu_vector_db_torch.monitoring import (
    get_registry, record_request, tracing)
from tpu_vector_db_torch.monitoring.health import HealthChecker
from tpu_vector_db_torch.security.auth import auth_config, hash_api_key
from tpu_vector_db_torch.store.config import StoreCapacityError
from tpu_vector_db_torch.service.errors import PeerLostError
from tpu_vector_db_torch.service.manager import VectorStoreManager
from tpu_vector_db_torch.store.vector_store import resolve_device

logger = logging.getLogger(__name__)

UNAUTH_PATHS = {"/", "/health", "/system/info", "/config",
                "/vectors/health", "/monitoring/health"}
# the least timeout of the multi-host process group: how long process 0
# waits for the others to join, and how long a collective may wait
GROUP_TIMEOUT_S = 120.0


# --------------------------------------------------------------- middleware

@web.middleware
async def request_tracking_middleware(request: web.Request, handler):
    """Request id + structured log fields + latency metrics + headers."""
    req_id = uuid.uuid4().hex[:16]
    auth = request.headers.get("Authorization")
    token = request_context.set({
        "request_id": req_id,
        "user_key_hash": hash_api_key(auth)[:12] if auth else None,
        "path": request.path,
    })
    t0 = time.perf_counter()
    status = 500
    response: web.StreamResponse | None = None
    try:
        with tracing.span("api.request", rid=req_id):
            response = await handler(request)
        status = response.status
        return response
    finally:
        dt = time.perf_counter() - t0
        record_request(dt, error=status >= 500)
        # feed the degradation manager from the REAL serving path (it was
        # previously only told about failures, so its level could never
        # change — review finding); evaluate is throttled to 1/s
        deg = request.app["manager"].errors.degradation
        deg.record_request(failed=status >= 500)
        deg.maybe_evaluate()
        if response is not None and not response.prepared:
            response.headers["X-Request-ID"] = req_id
            response.headers["X-Response-Time"] = f"{dt * 1e3:.2f}ms"
        logger.info("%s %s -> %d in %.2fms", request.method, request.path,
                    status, dt * 1e3)
        request_context.reset(token)


@web.middleware
async def rate_limit_middleware(request: web.Request, handler):
    """Tiered limits with X-RateLimit headers; parity with reference
    api/middleware/rate_limiting.py:335-384 (which was never registered)."""
    limiter: ProductionRateLimiter = request.app["rate_limiter"]
    if request.path in UNAUTH_PATHS or request.path.startswith("/debug"):
        return await handler(request)
    auth = request.headers.get("Authorization")
    tier = classify_tier(auth)
    op = classify_operation(request.path)
    key = hash_api_key(auth) if auth else request.remote or "anon"
    decision = limiter.check(key, tier, op)
    if not decision.allowed:
        return web.json_response(
            {"error": f"rate limit exceeded ({decision.reason})",
             "code": 429, "timestamp": time.time()},
            status=429,
            headers={"Retry-After": str(int(decision.retry_after_s) + 1),
                     "X-RateLimit-Limit": str(decision.limit),
                     "X-RateLimit-Remaining": "0"})
    try:
        response = await handler(request)
        response.headers["X-RateLimit-Limit"] = str(decision.limit)
        response.headers["X-RateLimit-Remaining"] = str(decision.remaining)
        return response
    finally:
        limiter.release(key, tier, op)


@web.middleware
async def error_middleware(request: web.Request, handler):
    """Structured {error, code, timestamp} bodies (reference main.py:170-202)."""
    try:
        return await handler(request)
    except web.HTTPException as exc:
        if exc.status >= 400:
            return web.json_response(
                {"error": exc.reason, "code": exc.status,
                 "timestamp": time.time()},
                status=exc.status)
        raise
    except StoreCapacityError as exc:
        # over-HBM store/add: 413 with the capacity-mode guidance intact
        return web.json_response(
            {"error": str(exc), "code": 413, "timestamp": time.time()},
            status=413)
    except ValueError as exc:
        return web.json_response(
            {"error": str(exc), "code": 400, "timestamp": time.time()},
            status=400)
    except KeyError as exc:
        return web.json_response(
            {"error": f"not found: {exc}", "code": 404,
             "timestamp": time.time()},
            status=404)
    except PeerLostError as exc:
        # multi-host peer death: a clean, bounded 503 instead of a hung
        # collective
        return web.json_response(
            {"error": str(exc), "code": 503, "timestamp": time.time(),
             "degraded": "peer_lost"},
            status=503)
    except Exception:  # noqa: BLE001 — last-resort boundary
        logger.exception("unhandled error on %s", request.path)
        # (degradation accounting happens once, in the outer tracking
        # middleware, off the response status)
        return web.json_response(
            {"error": "internal server error", "code": 500,
             "timestamp": time.time()},
            status=500)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    """CORS + gzip responses (reference mounted CORSMiddleware +
    GZipMiddleware, main.py:120-128)."""
    if request.method == "OPTIONS":
        response = web.Response(status=204)
    else:
        response = await handler(request)
    origin = request.headers.get("Origin")
    if origin:
        response.headers["Access-Control-Allow-Origin"] = origin
        response.headers["Access-Control-Allow-Methods"] = \
            "GET, POST, DELETE, OPTIONS"
        response.headers["Access-Control-Allow-Headers"] = \
            "Authorization, Content-Type"
    if (isinstance(response, web.Response) and response.body and
            len(response.body) > 4096 and
            "gzip" in request.headers.get("Accept-Encoding", "") and
            "Content-Encoding" not in response.headers):
        import gzip
        response.body = gzip.compress(bytes(response.body), 5)
        response.headers["Content-Encoding"] = "gzip"
    return response


# ---------------------------------------------------------------- assembly

def create_app(manager: VectorStoreManager | None = None,
               redis_url: str | None = None,
               device: str | None = None) -> web.Application:
    """``device`` None: the manager's, or else ``setup_runtime()``'s
    default ("cuda" unless ``VDB_FORCE_CPU`` is set). Raises when that
    device is CUDA and no CUDA device is present."""
    default = setup_runtime()
    if device is None:
        device = manager.device if manager is not None else default
    resolve_device(device)
    setup_logging()
    # order: tracking outermost (sees every response), then rate limiting,
    # then the error boundary innermost so limiter/tracking headers attach
    # to error responses too
    app = web.Application(
        middlewares=[cors_middleware, request_tracking_middleware,
                     rate_limit_middleware, error_middleware],
        client_max_size=512 * 2**20)  # bulk uploads

    app["manager"] = manager or VectorStoreManager(device=device)
    app["device"] = device
    from tpu_vector_db_torch.service.batcher import QueryCoalescer
    app["coalescer"] = QueryCoalescer.from_env(app["manager"])
    app["rate_limiter"] = ProductionRateLimiter(redis_url)
    app["health_checker"] = HealthChecker(device)
    app["started_at"] = time.time()
    app["version"] = __version__

    from tpu_vector_db_torch.api.routes.batch import BatchOperationManager
    app["batch_ops"] = BatchOperationManager()

    from tpu_vector_db_torch.api.routes import (
        admin, batch, monitoring_routes, performance, root, vectors)
    root.register(app)
    vectors.register(app)
    admin.register(app)
    performance.register(app)
    monitoring_routes.register(app)
    batch.register(app)

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


async def _on_startup(app: web.Application) -> None:
    """Warmup: multi-host bootstrap, device probe, store warmup
    (reference main.py:64-106)."""
    get_registry().start_sampler()
    manager = app["manager"]
    manager.errors.install_shutdown_handlers()
    # multi-host bootstrap, env-gated: VECTOR_DB_COORDINATOR (host:port of
    # process 0) + VECTOR_DB_NUM_PROCESSES + VECTOR_DB_PROCESS_ID on every
    # host. No try: a host that cannot join its group does not start. The
    # group's own timeout is at least the watchdog's, so the watchdog
    # trips first
    coordinator = os.environ.get("VECTOR_DB_COORDINATOR")
    if coordinator:
        from tpu_vector_db_torch.parallel.mesh import bootstrap_distributed
        bootstrap_distributed(
            coordinator_address=coordinator,
            num_processes=int(os.environ["VECTOR_DB_NUM_PROCESSES"]),
            process_id=int(os.environ["VECTOR_DB_PROCESS_ID"]),
            timeout_s=max(manager._collective_timeout_s,
                          GROUP_TIMEOUT_S))
    # no try: a server whose device cannot run a matmul does not start
    dev = torch.device(app["device"])
    x = torch.ones((128, 128), device=dev)
    total = (x @ x).sum().item()
    if total != 128.0 ** 3:
        raise RuntimeError(f"device probe on {dev} summed to {total}")
    logger.info("device warm: %s (%s)", dev,
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "host")
    if coordinator and manager._sharded:
        manager.mesh()   # a collective: every process makes it now
    warmed = manager.warmup_all_stores()
    if warmed:
        logger.info("warmed %d stores", len(warmed))
    if auth_config.generated:
        logger.warning("DEV KEYS — api: %s admin: %s",
                       auth_config.api_key, auth_config.admin_key)


async def _on_cleanup(app: web.Application) -> None:
    if app.get("coalescer") is not None:
        await app["coalescer"].aclose()
    get_registry().stop_sampler()
    app["manager"].shutdown()
