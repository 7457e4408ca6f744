"""Multi-tenant store manager.

Capability parity with BOTH reference managers (SURVEY.md §2.D):
VectorStoreManager (api/routes/vectors.py:37-144 — lazy get, thread-pool
offload, warmup_all_stores, aggregate stats, singleton) and
ProductionVectorStoreManager (service/production_integration.py:39-128 —
explicit create/delete with rmtree, async add/query, owned error handler).
One class, wired to the error handler and circuit breakers for real.

The port of ``tpu_vector_db.service.manager``: stores are
``TorchVectorStore`` on ``device`` ("cuda" unless the caller passes
"cpu"). The device is resolved when the first store is made, so making
a manager (and importing this module) touches no CUDA. ``sharded=True``
(or ``VECTOR_DB_SHARDED=1``) makes ``parallel.ShardedVectorStore``s over
``make_device_mesh()``: every visible card for "cuda", one CPU shard for
"cpu". Under multi-host serving (``VECTOR_DB_COORDINATOR``: the app
joins the process group at startup) the sharded stores' mesh spans the
processes, and every device call is bounded by the collective watchdog
(``VECTOR_DB_COLLECTIVE_TIMEOUT_S``, default 120 s): a collective that
fails or times out latches ``peer_lost``, the request becomes a
``PeerLostError`` (503), and every later call fails fast.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tpu_vector_db_torch.service.error_handler import (
    ErrorHandler, get_error_handler)
from tpu_vector_db_torch.service.errors import PeerLostError
from tpu_vector_db_torch.store.config import VectorStoreConfig
from tpu_vector_db_torch.store.vector_store import TorchVectorStore

logger = logging.getLogger(__name__)

DEFAULT_BASE = os.environ.get(
    "VECTOR_DB_DATA_DIR", str(Path.home() / ".tpu_vector_db" / "stores"))


class VectorStoreManager:
    """Registry of tenant stores keyed (user_id, model_id)."""

    def __init__(self, base_path: str | os.PathLike = DEFAULT_BASE,
                 max_workers: int | None = None,
                 sharded: bool | None = None,
                 device: str = "cuda",
                 errors: ErrorHandler | None = None) -> None:
        if max_workers is None:
            # queries are concurrent store READERS (RWLock), each worker
            # holding one device call; on one card the workers launch on
            # the same default stream, so their kernels run one after
            # another and the pool overlaps only host work
            max_workers = int(os.environ.get("VDB_WORKERS", "4"))
        if sharded is None:
            sharded = os.environ.get("VECTOR_DB_SHARDED", "0") == "1"
        self._sharded = sharded
        self._mesh = None
        self.base_path = Path(base_path)
        self.device = device
        self._stores: dict[tuple[str, str], TorchVectorStore] = {}
        self._lock = threading.Lock()
        # worker pool keeps device work off the event loop
        self.executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="vdb-worker")
        self.errors = errors if errors is not None else get_error_handler()
        # multi-host serving watchdog: when a peer process dies, a
        # collective fails (gloo: "Connection closed by peer") or, with a
        # stalled peer, waits; the survivor must degrade with a bounded
        # 503, not hang request threads. Active only under the
        # multi-host bootstrap's env; the timeout must exceed the slowest
        # legitimate device call
        self._multihost = bool(os.environ.get("VECTOR_DB_COORDINATOR"))
        self._collective_timeout_s = float(os.environ.get(
            "VECTOR_DB_COLLECTIVE_TIMEOUT_S", "120"))
        self.peer_lost = False

    # ------------------------------------------------------------ lifecycle

    @staticmethod
    def _encode_tenant(s: str) -> str:
        """Collision-free, reversible dir-name encoding of a tenant id.

        Percent-encodes everything outside [A-Za-z0-9_-] (including '.',
        so '.', '..' and path separators can't escape the base dir).
        Lossy sanitization mapped distinct ids ('a.b', 'a_b') onto one
        directory, letting two store instances clobber each other's files.
        """
        if not s:
            raise ValueError("tenant id must be non-empty")
        out = []
        for ch in s:
            if ch.isascii() and (ch.isalnum() or ch in "-_"):
                out.append(ch)
            else:
                out.extend(f"%{b:02X}" for b in ch.encode("utf-8"))
        return "".join(out)

    @staticmethod
    def _decode_tenant(name: str) -> str:
        from urllib.parse import unquote
        return unquote(name)

    @staticmethod
    def _legacy_encode(s: str) -> str:
        """The round-1 lossy sanitizer (every non-alnum -> '_'): kept only
        to FIND stores created before the reversible encoding so an
        upgrade doesn't orphan tenants whose ids contain encoded chars
        (review finding)."""
        return "".join(ch if ch.isalnum() else "_" for ch in s)

    def _store_path(self, user_id: str, model_id: str) -> Path:
        path = (self.base_path / self._encode_tenant(user_id)
                / self._encode_tenant(model_id))
        if not (path / "manifest.json").exists():
            legacy = (self.base_path / self._legacy_encode(user_id)
                      / self._legacy_encode(model_id))
            if legacy != path and (legacy / "manifest.json").exists():
                # migrate on first access: rename the legacy directory to
                # the reversible-encoded path. The FIRST tenant to touch a
                # colliding legacy name claims it exactly once; later
                # distinct ids that share the lossy legacy encoding (e.g.
                # 'a.b' vs 'a b' -> 'a_b') then get fresh stores instead
                # of silently opening another tenant's data (review
                # finding: cross-tenant exposure on upgraded deployments).
                try:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    legacy.rename(path)
                    logger.info("migrated legacy store dir %s -> %s",
                                legacy, path)
                except OSError:
                    # lost a migration race or read-only FS: if the new
                    # path materialized, use it; else serve legacy in place
                    if not (path / "manifest.json").exists():
                        return legacy
        return path

    def mesh(self):
        """The sharded stores' mesh, made once: every visible card for
        "cuda", one CPU shard for "cpu"; under a process group it spans
        the processes (its making is a collective, so the app makes it
        at startup, on every process at once)."""
        if self._mesh is None:
            from tpu_vector_db_torch.parallel import make_device_mesh
            self._mesh = make_device_mesh(
                devices=["cpu"] if torch.device(self.device).type == "cpu"
                else None)
        return self._mesh

    def _make_store(self, path: Path, config: VectorStoreConfig | None):
        if self._sharded:
            from tpu_vector_db_torch.parallel import ShardedVectorStore
            return ShardedVectorStore(path, config, mesh=self.mesh())
        return TorchVectorStore(path, config, device=self.device)

    def store_exists(self, user_id: str, model_id: str) -> bool:
        with self._lock:
            if (user_id, model_id) in self._stores:
                return True
        return (self._store_path(user_id, model_id) / "manifest.json").exists()

    def get_store(self, user_id: str, model_id: str,
                  config: VectorStoreConfig | None = None,
                  create: bool = True) -> TorchVectorStore:
        key = (user_id, model_id)
        with self._lock:
            store = self._stores.get(key)
            if store is not None:
                return store
            path = self._store_path(user_id, model_id)
            if not create and not (path / "manifest.json").exists():
                raise KeyError(f"store {user_id}/{model_id} does not exist")
            # config=None lets the store restore its persisted config from
            # manifest.json — a reopened store keeps its created-with
            # dimension/metric/dtype/ANN settings (round-1 data-loss fix)
            store = self._make_store(path, config)
            self._stores[key] = store
            return store

    def create_store(self, user_id: str, model_id: str,
                     config: VectorStoreConfig) -> TorchVectorStore:
        key = (user_id, model_id)
        with self._lock:
            if key in self._stores or \
                    (self._store_path(*key) / "manifest.json").exists():
                raise FileExistsError(f"store {user_id}/{model_id} exists")
            store = self._make_store(self._store_path(*key), config)
            if store.config.persist_mode != "off":
                store._save()  # manifest now, even while empty/clean —
                # flush() alone skips a never-dirtied store
            self._stores[key] = store
            return store

    def delete_store(self, user_id: str, model_id: str,
                     force: bool = False) -> None:
        key = (user_id, model_id)
        with self._lock:
            store = self._stores.pop(key, None)
        if store is not None and len(store) > 0 and not force:
            with self._lock:
                self._stores[key] = store  # restore registration
            raise ValueError(
                f"store {user_id}/{model_id} is not empty; pass force=True")
        path = self._store_path(user_id, model_id)
        if store is None and path.exists():
            # not loaded: check emptiness from the manifest
            import json
            try:
                manifest = json.loads((path / "manifest.json").read_text())
                if manifest.get("count", 0) > 0 and not force:
                    raise ValueError(
                        f"store {user_id}/{model_id} is not empty; "
                        "pass force=True")
            except (OSError, ValueError) as e:
                if isinstance(e, ValueError) and "not empty" in str(e):
                    raise
        shutil.rmtree(path, ignore_errors=True)

    def list_stores(self, user_id: str | None = None) -> list[dict]:
        out = []
        if not self.base_path.exists():
            return out
        for user_dir in sorted(self.base_path.iterdir()):
            if not user_dir.is_dir():
                continue
            user_name = self._decode_tenant(user_dir.name)
            if user_id is not None and user_name != user_id:
                continue
            for model_dir in sorted(user_dir.iterdir()):
                if (model_dir / "manifest.json").exists():
                    model_name = self._decode_tenant(model_dir.name)
                    entry = {"user_id": user_name,
                             "model_id": model_name}
                    key = (user_name, model_name)
                    with self._lock:
                        store = self._stores.get(key)
                    if store is not None:
                        entry.update(store.get_stats())
                    out.append(entry)
        return out

    # ---------------------------------------------------------- async wraps

    async def _dispatch(self, fn):
        """Run device work in the executor, off the event loop. Under
        multi-host serving the call is bounded by the collective watchdog:
        a timeout or a failed collective latches peer_lost, the request
        503s cleanly, and every later call fast-fails without touching
        the device (a stalled collective's worker thread waits out the
        group's own timeout; recovery is a serving-group restart)."""
        if self._multihost and self.peer_lost:
            raise PeerLostError(
                "node degraded: a peer process was lost mid-serving; "
                "restart the serving group")
        fut = asyncio.get_running_loop().run_in_executor(self.executor, fn)
        if not self._multihost:
            return await fut
        try:
            return await asyncio.wait_for(
                fut, timeout=self._collective_timeout_s)
        except asyncio.TimeoutError:
            self.peer_lost = True
            logger.critical(
                "distributed collective exceeded %.0fs; peer process "
                "presumed dead; node degraded", self._collective_timeout_s)
            raise PeerLostError(
                f"distributed collective exceeded "
                f"{self._collective_timeout_s:.0f}s: peer process presumed "
                "dead; node degraded (restart the serving group)")
        except Exception as exc:  # noqa: BLE001 — classify, then re-raise
            # gloo FAILS the collective when a peer's connection closes
            # ("Connection closed by peer"): the same death, seen sooner
            if self._is_peer_failure(exc):
                self.peer_lost = True
                logger.critical("distributed collective failed (%s); peer "
                                "process presumed dead; node degraded", exc)
                raise PeerLostError(
                    f"distributed collective failed ({exc}); node degraded "
                    "(restart the serving group)") from exc
            raise

    @staticmethod
    def _is_peer_failure(exc: Exception) -> bool:
        text = repr(exc).lower()
        return any(marker in text for marker in (
            "connection closed by peer", "gloo", "coordination service",
            "heartbeat", "connection reset", "all-gather failed",
            "allgather failed", "collective"))

    async def add_vectors_async(self, user_id: str, model_id: str,
                                vectors, metadata=None) -> dict:
        # lazy creation infers the dimension from the payload (parity with
        # the batch route): creating with the 384-dim default would fail
        # the add on dimension mismatch while leaving a phantom store
        # registered, turning later /admin/create_store into a 409
        # (review finding)
        config = None
        if not self.store_exists(user_id, model_id):
            try:
                import numpy as np
                arr = np.asarray(vectors, dtype=np.float32)
                if arr.ndim == 2 and arr.shape[1] > 0:
                    config = VectorStoreConfig(dimension=int(arr.shape[1]))
            except (ValueError, TypeError):
                pass  # malformed payload: let add_vectors raise its 400
        store = self.get_store(user_id, model_id, config)
        # per-tenant breaker: one tenant's failing store must not trip
        # every tenant (error_handler.breaker docstring)
        breaker = self.errors.breaker(
            f"vector_add:{user_id}/{model_id}")
        return await self._dispatch(
            lambda: breaker.call(store.add_vectors, vectors, metadata))

    async def delete_vectors_async(self, user_id: str, model_id: str,
                                   indices) -> dict:
        store = self.get_store(user_id, model_id, create=False)
        breaker = self.errors.breaker(
            f"vector_delete:{user_id}/{model_id}")
        return await self._dispatch(
            lambda: breaker.call(store.delete_vectors, indices))

    async def query_async(self, user_id: str, model_id: str, query_vector,
                          k: int = 10, filter_metadata=None,
                          use_ann: bool = True, rerank: bool = False):
        store = self.get_store(user_id, model_id, create=False)
        breaker = self.errors.breaker(
            f"vector_query:{user_id}/{model_id}")
        return await self._dispatch(
            lambda: breaker.call(store.query, query_vector, k,
                                 filter_metadata, use_ann, rerank))

    async def batch_query_async(self, user_id: str, model_id: str,
                                query_vectors, k: int = 10,
                                filter_metadata=None, use_ann: bool = True,
                                rerank: bool = False):
        store = self.get_store(user_id, model_id, create=False)
        breaker = self.errors.breaker(
            f"vector_query:{user_id}/{model_id}")
        return await self._dispatch(
            lambda: breaker.call(store.batch_query, query_vectors, k,
                                 filter_metadata, use_ann, rerank))

    # ---------------------------------------------------------------- stats

    def warmup_all_stores(self) -> dict:
        results = {}
        with self._lock:
            stores = dict(self._stores)
        for (user, model), store in stores.items():
            results[f"{user}/{model}"] = store.warmup()
        return results

    def get_stats(self) -> dict:
        with self._lock:
            stores = dict(self._stores)
        per_store = {f"{u}/{m}": s.get_stats() for (u, m), s in stores.items()}
        return {
            "loaded_stores": len(per_store),
            "total_vectors": sum(s["vector_count"] for s in per_store.values()),
            "total_memory_mb": round(
                sum(s["memory_usage_mb"] for s in per_store.values()), 3),
            "stores": per_store,
        }

    def shutdown(self) -> None:
        with self._lock:
            stores = list(self._stores.values())
            self._stores.clear()
        for store in stores:
            try:
                store.close()
            except Exception:  # noqa: BLE001
                logger.exception("error closing store")
        self.executor.shutdown(wait=False)


# module-level singleton, parity with reference api/routes/vectors.py:144;
# it resolves its device only when its first store is made
store_manager = VectorStoreManager()
