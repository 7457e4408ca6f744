"""Micro-batching for concurrent single-vector queries.

REST clients send one vector per request, while one exact scan of the
store serves a batch of queries for far less than as many batch-1 scans
cost: each row tile is read from device memory once for the whole batch. The
coalescer holds a single-query request for up to ``window_ms`` (or until
``max_batch`` queued) and folds every compatible concurrent request for
the same (store, k, use_ann) lane into ONE ``batch_query`` call, fanning
results back to each waiter. Under low concurrency the added latency is
bounded by ``window_ms`` (default 1.5 ms).

``batch_query`` pads a flush to a power of two, and the scan picks its
kernel design from that batch size (``ops/cuda_scan.py::_launch_plan``),
so a coalesced request may be scored by another design than a direct
batch-1 one: f32 keys can then differ in the last bits.

Filtered queries bypass coalescing (filters change the device program and
rarely repeat across tenants in the same window).
"""

from __future__ import annotations

import asyncio
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


class _Lane:
    __slots__ = ("items", "timer")

    def __init__(self) -> None:
        self.items: list[tuple[np.ndarray, asyncio.Future]] = []
        self.timer: asyncio.TimerHandle | None = None


class QueryCoalescer:
    """Folds concurrent same-store single queries into one device batch."""

    def __init__(self, manager, window_ms: float = 1.5,
                 max_batch: int = 64) -> None:
        self.manager = manager
        self.window_s = max(window_ms, 0.0) / 1e3
        self.max_batch = max(int(max_batch), 1)
        self._lanes: dict[tuple, _Lane] = {}
        self.batches = 0          # flushes executed (observability)
        self.coalesced = 0        # queries served through a shared batch
        # flush-size histogram keyed by the power-of-two bucket the batch
        # pads to (= the compiled device shape it runs under): the load
        # benchmark's evidence that concurrency actually reaches the
        # batched regime instead of degenerating to batch-1 flushes
        self.batch_size_hist: dict[int, int] = {}

    @classmethod
    def from_env(cls, manager) -> "QueryCoalescer | None":
        """VDB_COALESCE_MS: window in ms; "0"/"off" disables. Default 1.5."""
        raw = os.environ.get("VDB_COALESCE_MS", "1.5")
        if raw.lower() in ("0", "off", "false", ""):
            return None
        try:
            window = float(raw)
        except ValueError:
            window = 1.5
        batch = int(os.environ.get("VDB_COALESCE_BATCH", "64"))
        return cls(manager, window_ms=window, max_batch=batch)

    async def query(self, user_id: str, model_id: str, vector: np.ndarray,
                    k: int, filter_metadata=None, use_ann: bool = True,
                    rerank: bool = False):
        """Same contract as manager.query_async."""
        if filter_metadata is not None or self.window_s == 0.0:
            return await self.manager.query_async(
                user_id, model_id, vector, k=k,
                filter_metadata=filter_metadata, use_ann=use_ann,
                rerank=rerank)
        # validate THIS request's shape before it joins a lane: one
        # malformed vector must not fail every coalesced neighbor (the
        # np.stack / batch validation error would propagate to all
        # waiters — review finding)
        from tpu_vector_db_torch.utils.validation import validate_vector_shape
        store = self.manager.get_store(user_id, model_id, create=False)
        arr = validate_vector_shape(vector, store.config.dimension)
        if arr.shape[0] != 1:
            raise ValueError("query() takes one vector; use batch_query()")
        loop = asyncio.get_running_loop()
        key = (user_id, model_id, int(k), bool(use_ann), bool(rerank))
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _Lane()
        fut: asyncio.Future = loop.create_future()
        lane.items.append((arr.reshape(-1), fut))
        if len(lane.items) >= self.max_batch:
            self._detach_and_flush(key, lane)
        elif lane.timer is None:
            lane.timer = loop.call_later(
                self.window_s, self._detach_and_flush, key, lane)
        return await fut

    def _detach_and_flush(self, key: tuple,
                          lane: _Lane) -> "asyncio.Task | None":
        if self._lanes.get(key) is lane:
            del self._lanes[key]
        if lane.timer is not None:
            lane.timer.cancel()
            lane.timer = None
        if lane.items:
            return asyncio.ensure_future(self._run(key, lane.items))
        return None

    async def _run(self, key: tuple,
                   items: list[tuple[np.ndarray, asyncio.Future]]) -> None:
        user_id, model_id, k, use_ann, rerank = key
        try:
            arr = np.stack([v for v, _ in items])
            results = await self.manager.batch_query_async(
                user_id, model_id, arr, k=k, use_ann=use_ann, rerank=rerank)
            self.batches += 1
            bucket = 1
            while bucket < len(items):
                bucket *= 2
            self.batch_size_hist[bucket] = \
                self.batch_size_hist.get(bucket, 0) + 1
            if len(items) > 1:
                self.coalesced += len(items)
            for (_, fut), res in zip(items, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as exc:  # noqa: BLE001 — propagate to every waiter
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(exc)

    async def aclose(self) -> None:
        """Flush every pending lane now (server shutdown): waiters get
        their results instead of hanging on a dead event loop."""
        tasks = [self._detach_and_flush(key, lane)
                 for key, lane in list(self._lanes.items())]
        # wait for the in-flight batch_query calls to actually finish —
        # sleep(0) only let the tasks START, so manager.shutdown() could
        # race the device sweep and error every waiter (review finding)
        tasks = [t for t in tasks if t is not None]
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def get_stats(self) -> dict:
        return {"window_ms": self.window_s * 1e3,
                "max_batch": self.max_batch,
                "batches": self.batches,
                "coalesced_queries": self.coalesced,
                "batch_size_hist": dict(sorted(
                    self.batch_size_hist.items()))}
