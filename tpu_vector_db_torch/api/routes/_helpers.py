"""Shared route helpers: auth guards, pydantic parsing, result formatting."""

from __future__ import annotations

import functools

import torch
from aiohttp import web
from pydantic import BaseModel, ValidationError

from tpu_vector_db_torch.api import query_body
from tpu_vector_db_torch.monitoring import record_query_body, tracing
from tpu_vector_db_torch.ops.distance import raw_score_to_similarity_distance
from tpu_vector_db_torch.security.auth import verify_admin_key, verify_api_key


def _credential(request: web.Request) -> str | None:
    """Authorization bearer or X-API-Key header (the reference's two SDKs
    used one each; both are accepted)."""
    return (request.headers.get("Authorization")
            or request.headers.get("X-API-Key"))


def require_api_key(handler):
    """Bearer-token guard (reference security/auth.py:52 as a FastAPI dep)."""
    @functools.wraps(handler)
    async def wrapper(request: web.Request):
        if not verify_api_key(_credential(request)):
            raise web.HTTPUnauthorized(reason="invalid or missing API key")
        return await handler(request)
    return wrapper


def require_admin_key(handler):
    @functools.wraps(handler)
    async def wrapper(request: web.Request):
        if not verify_admin_key(_credential(request)):
            raise web.HTTPForbidden(reason="admin key required")
        return await handler(request)
    return wrapper


async def parse_model(request: web.Request, model_cls: type[BaseModel],
                      vectors: tuple[str, int] | None = None):
    """The request's JSON body validated as ``model_cls``: 400 for a body
    that is not JSON, 422 for one the model refuses. ``vectors``: the
    model's vector field and its rank (1 or 2), which the compiled path
    (``api/query_body.py``) parses into a float32 array where it takes
    the whole body; the generic path decodes every other body, and each
    is counted under its path."""
    with tracing.span("api.decode", host_only=True):
        if vectors is not None:
            try:
                body = await request.read()
            except Exception:  # noqa: BLE001
                raise web.HTTPBadRequest(reason="invalid JSON body")
            model = None
            if (request.charset or "utf-8").lower() in ("utf-8", "utf8"):
                model = query_body.decode(body, model_cls, *vectors)
            route = "generic" if model is None else "native"
            record_query_body(route)
            tracing.annotate("route", route)
            if model is not None:
                return model
        try:
            payload = await request.json()
        except Exception:  # noqa: BLE001
            raise web.HTTPBadRequest(reason="invalid JSON body")
        try:
            return model_cls.model_validate(payload)
        except ValidationError as exc:
            raise web.HTTPUnprocessableEntity(
                reason="; ".join(
                    f"{'.'.join(str(p) for p in e['loc'])}: {e['msg']}"
                    for e in exc.errors()))


def format_results(indices, raw_scores, metadata, metric: str) -> list[dict]:
    """ONE canonical (similarity, distance) conversion for every path —
    the reference had two subtly different conventions
    (api/routes/vectors.py:236-258 vs :303-308)."""
    out = []
    for rank, (idx, raw, meta) in enumerate(
            zip(indices, raw_scores, metadata), start=1):
        sim, dist = raw_score_to_similarity_distance(raw, metric)
        out.append({"index": int(idx),
                    "similarity": round(float(sim), 6),
                    "distance": round(float(dist), 6),
                    "metadata": meta,
                    "rank": rank})
    return out


def accelerator(device: str) -> dict:
    """Backend, device count and names, and for a CUDA device its memory
    (the caching allocator's current and peak bytes, the card's total)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"backend": dev.type, "device_count": 1,
                "devices": [str(dev)]}
    n = torch.cuda.device_count()
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {"backend": "cuda", "device_count": n,
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "memory": {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": total,
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0)}}
