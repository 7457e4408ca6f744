"""Async client for the tpu-vector-db REST API.

The port's copy of ``tpu_vector_db/sdk/client.py``: httpx and numpy only,
it speaks to either package's server and touches no device.

Capability parity with the reference's full SDK
(sdk/python/mlx_vector_client.py:53-689): ClientConfig (base_url, keys,
timeouts, pool limits, retry policy, batch size, compression), a lazy
connection manager with pooling + stats, retry with exponential backoff that
skips 4xx, store management, vector ops accepting lists / numpy / other
array-likes, batch add through /v1/batch with graceful fallback to
/vectors/add, health and system info, an async store_context +
StoreContext scoped helper, quick_add / quick_search / semantic_search
one-liners, and a client-side benchmark. A thin synchronous wrapper covers
the reference's second, simpler client (mlx_vector_db_client.py:65-320).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import random
import time
from contextlib import asynccontextmanager
from dataclasses import dataclass

import httpx
import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class ClientConfig:
    base_url: str = "http://localhost:8000"
    api_key: str | None = None
    admin_key: str | None = None
    timeout_s: float = 30.0
    connect_timeout_s: float = 5.0
    max_connections: int = 32
    max_keepalive: int = 16
    retry_attempts: int = 3
    retry_base_delay_s: float = 0.25
    retry_max_delay_s: float = 8.0
    batch_size: int = 1000
    enable_http2: bool = False
    enable_compression: bool = True


@dataclass
class SearchResult:
    index: int
    similarity: float
    distance: float
    metadata: dict
    rank: int


@dataclass
class ClientStats:
    requests: int = 0
    retries: int = 0
    errors: int = 0
    total_time_s: float = 0.0

    def snapshot(self) -> dict:
        return {
            "requests": self.requests, "retries": self.retries,
            "errors": self.errors,
            "avg_latency_ms": round(
                self.total_time_s / self.requests * 1e3, 3)
            if self.requests else 0.0,
        }


def with_retry(fn=None, *, idempotent: bool = True):
    """Exponential backoff with jitter; 4xx responses never retry
    (parity with reference :160-205). Use ``@with_retry(idempotent=False)``
    for WRITES: a read-timeout after the server committed the add would
    otherwise re-send and silently duplicate vectors (review finding) —
    non-idempotent calls only retry failures that happened before the
    request could reach the server (connect errors)."""
    def deco(fn, idempotent=idempotent):
        @functools.wraps(fn)
        async def wrapper(self: "VectorDBClient", *args, **kwargs):
            cfg = self.config
            delay = cfg.retry_base_delay_s
            last: Exception | None = None
            for attempt in range(cfg.retry_attempts):
                try:
                    return await fn(self, *args, **kwargs)
                except httpx.HTTPStatusError as exc:
                    if exc.response.status_code < 500:
                        raise
                    last = exc
                except (httpx.ConnectError, httpx.ConnectTimeout) as exc:
                    last = exc  # request never reached the server
                except (httpx.TransportError, httpx.TimeoutException) as exc:
                    if not idempotent:
                        self._stats.errors += 1
                        raise  # the write may have committed server-side
                    last = exc
                if attempt < cfg.retry_attempts - 1:
                    self._stats.retries += 1
                    sleep = min(delay, cfg.retry_max_delay_s)
                    sleep *= 1.0 + random.uniform(-0.2, 0.2)
                    await asyncio.sleep(max(sleep, 0.0))
                    delay *= 2
            self._stats.errors += 1
            raise last  # type: ignore[misc]
        return wrapper
    if fn is not None:        # bare @with_retry form
        return deco(fn)
    return deco               # @with_retry(idempotent=False) form


def _to_float_lists(vectors) -> list[list[float]]:
    """list / numpy / array-like (a host tensor) -> JSON-ready nested lists
    (parity with reference _convert_vector :237-250)."""
    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr.tolist()


class VectorDBClient:
    def __init__(self, config: ClientConfig | None = None, **kwargs) -> None:
        self.config = config or ClientConfig(**kwargs)
        self._client: httpx.AsyncClient | None = None
        self._stats = ClientStats()

    # ------------------------------------------------------------ transport

    def _headers(self, admin: bool = False) -> dict:
        key = (self.config.admin_key or self.config.api_key) if admin \
            else self.config.api_key
        headers = {}
        if key:
            headers["Authorization"] = f"Bearer {key}"
        if self.config.enable_compression:
            headers["Accept-Encoding"] = "gzip"
        return headers

    async def _ensure_client(self) -> httpx.AsyncClient:
        if self._client is None or self._client.is_closed:
            self._client = httpx.AsyncClient(
                base_url=self.config.base_url,
                timeout=httpx.Timeout(self.config.timeout_s,
                                      connect=self.config.connect_timeout_s),
                limits=httpx.Limits(
                    max_connections=self.config.max_connections,
                    max_keepalive_connections=self.config.max_keepalive),
                http2=self.config.enable_http2)
        return self._client

    async def _request(self, method: str, path: str, admin: bool = False,
                       **kwargs) -> dict:
        client = await self._ensure_client()
        t0 = time.perf_counter()
        resp = await client.request(
            method, path, headers=self._headers(admin), **kwargs)
        self._stats.requests += 1
        self._stats.total_time_s += time.perf_counter() - t0
        resp.raise_for_status()
        return resp.json()

    async def close(self) -> None:
        if self._client is not None and not self._client.is_closed:
            await self._client.aclose()

    async def __aenter__(self) -> "VectorDBClient":
        await self._ensure_client()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def get_stats(self) -> dict:
        return self._stats.snapshot()

    # ------------------------------------------------------ store management

    @with_retry
    async def create_store(self, user_id: str, model_id: str,
                           dimension: int = 384, metric: str = "cosine",
                           index_type: str = "flat", **kwargs) -> dict:
        return await self._request("POST", "/admin/create_store", admin=True,
                                   json={"user_id": user_id,
                                         "model_id": model_id,
                                         "dimension": dimension,
                                         "metric": metric,
                                         "index_type": index_type, **kwargs})

    @with_retry
    async def delete_store(self, user_id: str, model_id: str,
                           force: bool = False) -> dict:
        return await self._request("DELETE", "/admin/store", admin=True,
                                   json={"user_id": user_id,
                                         "model_id": model_id,
                                         "force": force})

    @with_retry
    async def store_exists(self, user_id: str, model_id: str) -> bool:
        try:
            await self._request("GET", "/admin/store/stats", admin=True,
                                params={"user_id": user_id,
                                        "model_id": model_id})
            return True
        except httpx.HTTPStatusError as exc:
            if exc.response.status_code == 404:
                return False
            raise

    @with_retry
    async def get_store_stats(self, user_id: str, model_id: str) -> dict:
        return await self._request("GET", "/vectors/stats",
                                   params={"user_id": user_id,
                                           "model_id": model_id})

    @with_retry
    async def list_stores(self, user_id: str | None = None) -> list[dict]:
        params = {"user_id": user_id} if user_id else {}
        out = await self._request("GET", "/admin/list_stores", admin=True,
                                  params=params)
        return out["stores"]

    # ------------------------------------------------------------ vector ops

    @with_retry(idempotent=False)
    async def add_vectors(self, user_id: str, model_id: str, vectors,
                          metadata: list[dict] | None = None) -> dict:
        return await self._request("POST", "/vectors/add", json={
            "user_id": user_id, "model_id": model_id,
            "vectors": _to_float_lists(vectors), "metadata": metadata})

    async def batch_add_vectors(self, user_id: str, model_id: str, vectors,
                                metadata: list[dict] | None = None,
                                chunk_size: int | None = None,
                                wait: bool = True) -> dict:
        """Chunked ingest through /v1/batch/add with progress polling;
        falls back to plain /vectors/add if the batch API is absent
        (parity with reference :417-466)."""
        chunk = chunk_size or self.config.batch_size
        try:
            out = await self._request("POST", "/v1/batch/add", json={
                "user_id": user_id, "model_id": model_id,
                "vectors": _to_float_lists(vectors), "metadata": metadata,
                "chunk_size": chunk})
        except httpx.HTTPStatusError as exc:
            if exc.response.status_code != 404:
                raise
            return await self.add_vectors(user_id, model_id, vectors, metadata)
        if not wait:
            return out
        op_id = out["op_id"]
        while True:
            status = await self._request(
                "GET", f"/v1/batch/operations/{op_id}")
            if status["status"] in ("completed", "failed"):
                return status
            await asyncio.sleep(0.1)

    @with_retry(idempotent=False)
    async def delete_vectors(self, user_id: str, model_id: str,
                             indices: list[int]) -> dict:
        """Tombstone rows by id (ids stay stable)."""
        return await self._request("POST", "/vectors/delete", json={
            "user_id": user_id, "model_id": model_id,
            "indices": [int(i) for i in indices]})

    @with_retry
    async def query_vectors(self, user_id: str, model_id: str, query,
                            k: int = 10, filter_metadata: dict | None = None,
                            use_ann: bool = True,
                            rerank: bool = False) -> list[SearchResult]:
        out = await self._request("POST", "/vectors/query", json={
            "user_id": user_id, "model_id": model_id,
            "query": _to_float_lists(query)[0], "k": k,
            "filter_metadata": filter_metadata, "use_ann": use_ann,
            "rerank": rerank})
        return [SearchResult(**r) for r in out["results"]]

    @with_retry
    async def batch_query_vectors(self, user_id: str, model_id: str, queries,
                                  k: int = 10, rerank: bool = False,
                                  filter_metadata: dict | None = None
                                  ) -> list[list[SearchResult]]:
        out = await self._request("POST", "/vectors/batch_query", json={
            "user_id": user_id, "model_id": model_id,
            "queries": _to_float_lists(queries), "k": k,
            "filter_metadata": filter_metadata, "rerank": rerank})
        return [[SearchResult(**r) for r in row] for row in out["results"]]

    @with_retry
    async def count_vectors(self, user_id: str, model_id: str) -> int:
        out = await self._request("GET", "/vectors/count",
                                  params={"user_id": user_id,
                                          "model_id": model_id})
        return out["count"]

    # ----------------------------------------------------------------- misc

    @with_retry
    async def health_check(self) -> dict:
        return await self._request("GET", "/health")

    @with_retry
    async def system_info(self) -> dict:
        return await self._request("GET", "/system/info")

    @with_retry
    async def warmup(self, user_id: str | None = None,
                     model_id: str | None = None) -> dict:
        payload = ({"user_id": user_id, "model_id": model_id}
                   if user_id and model_id else {})
        return await self._request("POST", "/performance/warmup",
                                   json=payload)

    # --------------------------------------------------------- conveniences

    @asynccontextmanager
    async def store_context(self, user_id: str, model_id: str,
                            dimension: int = 384, metric: str = "cosine",
                            auto_create: bool = True, **kwargs):
        """Scoped helper bound to one store (reference :509-525,635-658)."""
        if auto_create and not await self.store_exists(user_id, model_id):
            await self.create_store(user_id, model_id, dimension=dimension,
                                    metric=metric, **kwargs)
        yield StoreContext(self, user_id, model_id)

    async def quick_add(self, user_id: str, model_id: str, vectors,
                        metadata=None, dimension: int | None = None) -> dict:
        arr = np.asarray(vectors, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if not await self.store_exists(user_id, model_id):
            await self.create_store(user_id, model_id,
                                    dimension=dimension or arr.shape[1])
        return await self.add_vectors(user_id, model_id, arr, metadata)

    async def quick_search(self, user_id: str, model_id: str, query,
                           k: int = 10) -> list[SearchResult]:
        return await self.query_vectors(user_id, model_id, query, k=k)

    async def semantic_search(self, user_id: str, model_id: str, query,
                              k: int = 10, min_similarity: float = 0.0
                              ) -> list[SearchResult]:
        results = await self.query_vectors(user_id, model_id, query, k=k)
        return [r for r in results if r.similarity >= min_similarity]

    async def benchmark_performance(self, user_id: str = "bench",
                                    model_id: str = "sdk",
                                    num_vectors: int = 1000,
                                    dimension: int = 384,
                                    num_queries: int = 100) -> dict:
        """Client-side round-trip benchmark (reference :589-624)."""
        return await self._request("POST", "/vectors/benchmark", json={
            "user_id": user_id, "model_id": model_id,
            "num_vectors": num_vectors, "dimension": dimension,
            "num_queries": num_queries})


class StoreContext:
    """Operations scoped to one (user_id, model_id)."""

    def __init__(self, client: VectorDBClient, user_id: str,
                 model_id: str) -> None:
        self._client = client
        self.user_id = user_id
        self.model_id = model_id

    async def add(self, vectors, metadata=None) -> dict:
        return await self._client.add_vectors(
            self.user_id, self.model_id, vectors, metadata)

    async def query(self, query, k: int = 10,
                    filter_metadata: dict | None = None):
        return await self._client.query_vectors(
            self.user_id, self.model_id, query, k=k,
            filter_metadata=filter_metadata)

    async def batch_query(self, queries, k: int = 10):
        return await self._client.batch_query_vectors(
            self.user_id, self.model_id, queries, k=k)

    async def count(self) -> int:
        return await self._client.count_vectors(self.user_id, self.model_id)

    async def stats(self) -> dict:
        return await self._client.get_store_stats(self.user_id, self.model_id)


class SyncVectorDBClient:
    """Blocking facade over the async client (the reference shipped a
    separate simpler sync-ish client; one loop-backed wrapper covers it).

    Every call runs on ONE dedicated background event loop: a fresh
    asyncio.run() per call (the old implementation) reused the httpx
    client's keepalive pool across loops, so the second call picked a
    connection bound to the first (closed) loop and died with
    'Event loop is closed' (review finding)."""

    def __init__(self, config: ClientConfig | None = None, **kwargs) -> None:
        import threading
        self._async = VectorDBClient(config, **kwargs)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="vdb-sync-client")
        self._thread.start()

    def _run(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result()

    def __getattr__(self, name):
        target = getattr(self._async, name)
        if asyncio.iscoroutinefunction(target):
            @functools.wraps(target)
            def sync_call(*args, **kwargs):
                return self._run(target(*args, **kwargs))
            return sync_call
        return target

    def close(self) -> None:
        if self._loop.is_closed():
            return
        self._run(self._async.close())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        self._loop.close()

    def __enter__(self) -> "SyncVectorDBClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create_client(base_url: str = "http://localhost:8000",
                  api_key: str | None = None, admin_key: str | None = None,
                  sync: bool = False, **kwargs):
    cfg = ClientConfig(base_url=base_url, api_key=api_key,
                       admin_key=admin_key, **kwargs)
    return SyncVectorDBClient(cfg) if sync else VectorDBClient(cfg)
