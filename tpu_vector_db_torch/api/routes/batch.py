"""Batch API v1: chunked operations, progress tracking, SSE, bulk upload,
webhooks.

The reference DEFINED this surface but never mounted it and it could not
import (api/routes/batch_v1.py:36,383 — see SURVEY.md §2.E "Unmounted batch
API"). This is the working implementation of the intended capabilities:

* POST /v1/batch/add      — chunked ingest with per-chunk progress
* POST /v1/batch/query    — chunked batched queries
* GET  /v1/batch/operations            — list operations
* GET  /v1/batch/operations/{op_id}    — one operation's status
* GET  /v1/batch/operations/{op_id}/stream — SSE progress stream
* POST /v1/batch/upload   — bulk .npz / .jsonl upload (multipart, temp-file
                            staging)
* POST /v1/batch/benchmark — batch-size sweep
* webhook completion notifications with retry (operation-level callback_url)
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
from aiohttp import web

from tpu_vector_db_torch.api.routes._helpers import (
    format_results, parse_model, require_api_key)
from pydantic import BaseModel, Field

logger = logging.getLogger(__name__)

DEFAULT_CHUNK = 10_000
MAX_TRACKED_OPS = 500


class OpStatus(str, Enum):
    pending = "pending"
    running = "running"
    completed = "completed"
    failed = "failed"


@dataclass
class BatchOperation:
    op_id: str
    kind: str
    user_id: str
    model_id: str
    total_items: int
    status: OpStatus = OpStatus.pending
    processed: int = 0
    started_at: float = field(default_factory=time.time)
    finished_at: float | None = None
    error: str | None = None
    result: dict | None = None
    callback_url: str | None = None
    _event: asyncio.Event = field(default_factory=asyncio.Event, repr=False)

    def to_dict(self) -> dict:
        return {
            "op_id": self.op_id, "kind": self.kind,
            "user_id": self.user_id, "model_id": self.model_id,
            "status": self.status.value,
            "progress": {"processed": self.processed,
                         "total": self.total_items,
                         "percent": round(100 * self.processed /
                                          max(self.total_items, 1), 1)},
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "duration_s": round((self.finished_at or time.time()) -
                                self.started_at, 3),
            "error": self.error,
            "result": self.result,
        }

    def notify(self) -> None:
        self._event.set()
        self._event = asyncio.Event()


class BatchOperationManager:
    """Tracks running/finished operations (capability of reference
    batch_v1.py:103-172), fires webhooks on completion with retry
    (:611-657)."""

    def __init__(self) -> None:
        self._ops: dict[str, BatchOperation] = {}
        self._lock = asyncio.Lock()
        # STRONG refs to fire-and-forget tasks: the event loop keeps only
        # weak references, so an unreferenced running ingest/webhook task
        # can be garbage-collected mid-execution, leaving the operation
        # 'running' forever (review finding / CPython asyncio docs)
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def create(self, **kwargs) -> BatchOperation:
        op = BatchOperation(op_id=uuid.uuid4().hex[:16], **kwargs)
        async with self._lock:
            if len(self._ops) >= MAX_TRACKED_OPS:
                done = [k for k, v in self._ops.items()
                        if v.status in (OpStatus.completed, OpStatus.failed)]
                for k in done[: len(self._ops) - MAX_TRACKED_OPS + 1]:
                    del self._ops[k]
            self._ops[op.op_id] = op
        return op

    async def get(self, op_id: str) -> BatchOperation | None:
        async with self._lock:
            return self._ops.get(op_id)

    async def list(self) -> list[dict]:
        async with self._lock:
            return [op.to_dict() for op in self._ops.values()]

    async def finish(self, op: BatchOperation, result: dict | None = None,
                     error: str | None = None) -> None:
        op.status = OpStatus.failed if error else OpStatus.completed
        op.error = error
        op.result = result
        op.finished_at = time.time()
        op.notify()
        if op.callback_url:
            self.spawn(self._fire_webhook(op))

    async def _fire_webhook(self, op: BatchOperation,
                            attempts: int = 3) -> None:
        import aiohttp
        payload = op.to_dict()
        delay = 1.0
        for attempt in range(attempts):
            try:
                # _public_only_connector re-checks DNS results at CONNECT
                # time: the submission-time validate_callback_url and this
                # delivery resolve independently, so a short-TTL rebinding
                # record could otherwise pass validation and then point at
                # loopback/metadata services when the webhook fires
                # (advisor TOCTOU finding)
                async with aiohttp.ClientSession(
                        connector=_public_only_connector()) as session:
                    async with session.post(
                            op.callback_url, json=payload,
                            timeout=aiohttp.ClientTimeout(total=10)) as resp:
                        if resp.status < 400:
                            return
                        logger.warning("webhook %s returned %d",
                                       op.callback_url, resp.status)
            except Exception as exc:  # noqa: BLE001
                logger.warning("webhook attempt %d failed: %s",
                               attempt + 1, exc)
            await asyncio.sleep(delay)
            delay *= 2


def get_op_manager(app: web.Application) -> BatchOperationManager:
    return app["batch_ops"]  # registered by create_app


def _is_internal_ip(ip_str: str) -> bool:
    import ipaddress
    ip = ipaddress.ip_address(str(ip_str).split("%")[0])
    return (ip.is_private or ip.is_loopback or ip.is_link_local
            or ip.is_reserved or ip.is_multicast or ip.is_unspecified)


def _allow_private_webhooks() -> bool:
    import os
    return os.environ.get("VECTOR_DB_WEBHOOK_ALLOW_PRIVATE", "0") == "1"


def _public_only_connector():
    """aiohttp TCPConnector whose resolver drops private/internal DNS
    results at connect time — the delivery-time half of the SSRF defence
    (validate_callback_url is the submission-time half). With the
    allow-private env set, returns a default connector."""
    import socket

    import aiohttp
    from aiohttp.resolver import DefaultResolver

    if _allow_private_webhooks():
        return aiohttp.TCPConnector()

    class _PublicOnlyResolver(aiohttp.abc.AbstractResolver):
        def __init__(self) -> None:
            self._inner = DefaultResolver()

        async def resolve(self, host, port=0, family=socket.AF_INET):
            infos = await self._inner.resolve(host, port, family)
            safe = [i for i in infos if not _is_internal_ip(i["host"])]
            if not safe:
                raise OSError(
                    f"webhook host {host!r} resolves only to "
                    "private/internal addresses (rejected at connect time)")
            return safe

        async def close(self) -> None:
            await self._inner.close()

    return aiohttp.TCPConnector(resolver=_PublicOnlyResolver())


def validate_callback_url(url: str) -> None:
    """Reject SSRF-able webhook targets: the server POSTs the completion
    payload to this URL from its own network position, so any API-key
    holder could otherwise aim it at link-local metadata services or
    internal endpoints (review finding). http(s) only; hosts resolving to
    private/loopback/link-local ranges 400 unless
    VECTOR_DB_WEBHOOK_ALLOW_PRIVATE=1 (dev/webhook-to-self setups).
    This is the submission-time check; _public_only_connector re-checks
    the actually-resolved addresses at delivery time (DNS-rebinding
    TOCTOU, advisor finding)."""
    import socket
    from urllib.parse import urlparse

    p = urlparse(url)
    if p.scheme not in ("http", "https") or not p.hostname:
        raise web.HTTPBadRequest(reason="callback_url must be http(s)")
    if _allow_private_webhooks():
        return
    try:
        infos = socket.getaddrinfo(p.hostname, None)
    except OSError:
        raise web.HTTPBadRequest(
            reason="callback_url host does not resolve")
    for info in infos:
        if _is_internal_ip(info[4][0]):
            raise web.HTTPBadRequest(
                reason="callback_url resolves to a private/internal "
                       "address (set VECTOR_DB_WEBHOOK_ALLOW_PRIVATE=1 "
                       "to allow)")


# ------------------------------------------------------------------ models

class BatchAddRequest(BaseModel):
    user_id: str
    model_id: str
    vectors: list[list[float]]
    metadata: list[dict] | None = None
    chunk_size: int = Field(default=DEFAULT_CHUNK, ge=1, le=100_000)
    callback_url: str | None = None


class BatchQueryV1Request(BaseModel):
    user_id: str
    model_id: str
    queries: list[list[float]]
    k: int = Field(default=10, ge=1, le=1000)
    chunk_size: int = Field(default=256, ge=1, le=4096)
    filter_metadata: dict | None = None


class BatchBenchmarkRequest(BaseModel):
    user_id: str = "bench"
    model_id: str = "batch_bench"
    dimension: int = Field(default=384, ge=8, le=4096)
    num_vectors: int = Field(default=10_000, ge=100, le=1_000_000)
    batch_sizes: list[int] = Field(default=[1, 8, 32, 128])
    k: int = Field(default=10, ge=1, le=1000)


# ------------------------------------------------------------------ routes

def register(app: web.Application) -> None:
    app.router.add_post("/v1/batch/add", batch_add)
    app.router.add_post("/v1/batch/query", batch_query)
    app.router.add_get("/v1/batch/operations", list_operations)
    app.router.add_get("/v1/batch/operations/{op_id}", get_operation)
    app.router.add_get("/v1/batch/operations/{op_id}/stream", stream_operation)
    app.router.add_post("/v1/batch/upload", bulk_upload)
    app.router.add_post("/v1/batch/benchmark", batch_benchmark)


async def _run_chunked_add(app: web.Application, op: BatchOperation,
                           vectors: np.ndarray, metadata, chunk: int) -> None:
    manager = app["manager"]
    op.status = OpStatus.running
    try:
        # lazily-created stores take their dimension from the data
        from tpu_vector_db_torch.store.config import VectorStoreConfig
        manager.get_store(op.user_id, op.model_id,
                          VectorStoreConfig(dimension=int(vectors.shape[1])))
        total_added = 0
        t0 = time.perf_counter()
        for start in range(0, len(vectors), chunk):
            part = vectors[start: start + chunk]
            meta_part = (metadata[start: start + chunk]
                         if metadata is not None else None)
            result = await manager.add_vectors_async(
                op.user_id, op.model_id, part, meta_part)
            total_added += result["added"]
            op.processed = min(start + chunk, len(vectors))
            op.notify()
        dt = time.perf_counter() - t0
        await get_op_manager(app).finish(op, result={
            "added": total_added,
            "vectors_per_second": round(total_added / max(dt, 1e-9), 1)})
    except Exception as exc:  # noqa: BLE001
        logger.exception("batch add %s failed", op.op_id)
        await get_op_manager(app).finish(op, error=str(exc))


@require_api_key
async def batch_add(request: web.Request) -> web.Response:
    body = await parse_model(request, BatchAddRequest)
    if body.callback_url:
        validate_callback_url(body.callback_url)
    vectors = np.asarray(body.vectors, np.float32)
    op = await get_op_manager(request.app).create(
        kind="batch_add", user_id=body.user_id, model_id=body.model_id,
        total_items=len(vectors), callback_url=body.callback_url)
    get_op_manager(request.app).spawn(_run_chunked_add(
        request.app, op, vectors, body.metadata, body.chunk_size))
    return web.json_response(
        {"op_id": op.op_id, "status": op.status.value,
         "stream": f"/v1/batch/operations/{op.op_id}/stream"},
        status=202)


@require_api_key
async def batch_query(request: web.Request) -> web.Response:
    body = await parse_model(request, BatchQueryV1Request)
    manager = request.app["manager"]
    queries = np.asarray(body.queries, np.float32)
    store = manager.get_store(body.user_id, body.model_id, create=False)
    t0 = time.perf_counter()
    all_results = []
    for start in range(0, len(queries), body.chunk_size):
        part = queries[start: start + body.chunk_size]
        batches = await manager.batch_query_async(
            body.user_id, body.model_id, part, k=body.k,
            filter_metadata=body.filter_metadata)
        all_results.extend(
            format_results(i, s, m, store.metric) for (i, s, m) in batches)
    dt = time.perf_counter() - t0
    return web.json_response({
        "results": all_results,
        "queries": len(queries),
        "query_time_ms": round(dt * 1e3, 2),
        "qps": round(len(queries) / max(dt, 1e-9), 1),
    })


@require_api_key
async def list_operations(request: web.Request) -> web.Response:
    ops = await get_op_manager(request.app).list()
    return web.json_response({"operations": ops, "count": len(ops)})


@require_api_key
async def get_operation(request: web.Request) -> web.Response:
    op = await get_op_manager(request.app).get(request.match_info["op_id"])
    if op is None:
        raise web.HTTPNotFound(reason="unknown operation id")
    return web.json_response(op.to_dict())


@require_api_key
async def stream_operation(request: web.Request) -> web.StreamResponse:
    """SSE progress stream (capability of reference batch_v1.py:179-193)."""
    op = await get_op_manager(request.app).get(request.match_info["op_id"])
    if op is None:
        raise web.HTTPNotFound(reason="unknown operation id")
    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })
    await resp.prepare(request)

    async def send(payload: dict) -> None:
        await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

    await send(op.to_dict())
    while op.status in (OpStatus.pending, OpStatus.running):
        event = op._event
        try:
            await asyncio.wait_for(event.wait(), timeout=5.0)
        except asyncio.TimeoutError:
            pass  # heartbeat
        await send(op.to_dict())
    await resp.write(b"event: done\ndata: {}\n\n")
    return resp


@require_api_key
async def bulk_upload(request: web.Request) -> web.Response:
    """Multipart .npz (array 'vectors') + optional .jsonl metadata upload
    with temp staging (capability of reference batch_v1.py:382-465)."""
    reader = await request.multipart()
    user_id = model_id = None
    vectors = None
    metadata = None
    async for part in reader:
        if part.name == "user_id":
            user_id = (await part.text()).strip()
        elif part.name == "model_id":
            model_id = (await part.text()).strip()
        elif part.name == "vectors":
            raw = await part.read(decode=False)
            try:
                with np.load(io.BytesIO(raw)) as z:
                    key = "vectors" if "vectors" in z.files else z.files[0]
                    vectors = np.asarray(z[key], np.float32)
            except Exception:
                try:
                    vectors = np.load(io.BytesIO(raw)).astype(np.float32)
                except Exception:
                    raise web.HTTPBadRequest(
                        reason="vectors part must be .npz or .npy")
        elif part.name == "metadata":
            text = (await part.read(decode=False)).decode("utf-8")
            metadata = [json.loads(line) for line in text.splitlines()
                        if line.strip()]
    if not user_id or not model_id or vectors is None:
        raise web.HTTPBadRequest(
            reason="multipart needs user_id, model_id, vectors")
    if metadata is not None and len(metadata) != len(vectors):
        raise web.HTTPBadRequest(reason="metadata length != vectors length")

    op = await get_op_manager(request.app).create(
        kind="bulk_upload", user_id=user_id, model_id=model_id,
        total_items=len(vectors))
    get_op_manager(request.app).spawn(_run_chunked_add(
        request.app, op, vectors, metadata, DEFAULT_CHUNK))
    return web.json_response(
        {"op_id": op.op_id, "rows": int(vectors.shape[0]),
         "dimension": int(vectors.shape[1]),
         "stream": f"/v1/batch/operations/{op.op_id}/stream"},
        status=202)


@require_api_key
async def batch_benchmark(request: web.Request) -> web.Response:
    """Batch-size sweep (capability of reference batch_v1.py:529-607)."""
    body = await parse_model(request, BatchBenchmarkRequest)
    manager = request.app["manager"]
    from tpu_vector_db_torch.store.config import VectorStoreConfig
    rng = np.random.default_rng(0)
    user, model = body.user_id, f"{body.model_id}_{body.dimension}"
    store = manager.get_store(user, model, VectorStoreConfig(
        dimension=body.dimension, persist_mode="off"))
    store.clear()
    vectors = rng.standard_normal(
        (body.num_vectors, body.dimension)).astype(np.float32)
    await manager.add_vectors_async(user, model, vectors)
    store.warmup()

    sweep = []
    for bs in body.batch_sizes:
        queries = vectors[rng.integers(0, body.num_vectors, bs)]
        t0 = time.perf_counter()
        await manager.batch_query_async(user, model, queries, k=body.k)
        dt = time.perf_counter() - t0
        sweep.append({"batch_size": bs,
                      "latency_ms": round(dt * 1e3, 3),
                      "qps": round(bs / max(dt, 1e-9), 1)})
    store.clear()
    return web.json_response({"dimension": body.dimension,
                              "num_vectors": body.num_vectors,
                              "sweep": sweep})
