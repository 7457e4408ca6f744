"""The system under test: a configuration's store, and its REST server.

``deployment_env`` turns the configuration's ``server`` block into the
environment the port reads (keys, tier, rate scale, coalescer, workers,
log level); it is set before the port's api is imported. ``build_store``
makes a ``VectorStoreManager`` and the tenant's store through the
library and adds the rows; ``ServerThread`` serves
``create_app(manager=...)`` on 127.0.0.1 on its own event loop thread
(as ``chip_smoke.py``'s does).
"""

from __future__ import annotations

import asyncio
import threading
from pathlib import Path

import numpy as np

TENANT = ("bench-tenant", "cohere768")


def deployment_env(config: dict) -> dict[str, str]:
    s = config["server"]
    return {"ENVIRONMENT": "production",
            "VECTOR_DB_API_KEY": s["api_key"],
            "VECTOR_DB_ADMIN_KEY": s["admin_key"],
            "VECTOR_DB_API_TIER": s["api_tier"],
            "VECTOR_DB_RATE_SCALE": str(s["rate_scale"]),
            "VDB_COALESCE_MS": str(s["coalesce_ms"]),
            "VDB_COALESCE_BATCH": str(s["coalesce_batch"]),
            "VDB_WORKERS": str(s["workers"]),
            "LOG_LEVEL": s["log_level"]}


def store_config(config: dict):
    from tpu_vector_db_torch.store.config import VectorStoreConfig
    st = config["store"]
    return VectorStoreConfig(
        dimension=int(config["dim"]), metric=st["metric"],
        storage_dtype=st["storage_dtype"], enable_ann=bool(st["enable_ann"]),
        ann_params=dict(st["ann_params"]), persist_mode=st["persist_mode"])


def build_store(config: dict, rows: np.ndarray, workdir: Path,
                device: str):
    """(manager, store) with ``rows`` added in one call."""
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    manager = VectorStoreManager(
        base_path=workdir / "stores", device=device,
        max_workers=int(config["server"]["workers"]),
        errors=ErrorHandler(workdir / "logs"))
    store = manager.create_store(*TENANT, store_config(config))
    store.add_vectors(rows)
    return manager, store


class ServerThread:
    """The port's app on 127.0.0.1 at a free port, on its own event loop
    in a thread. ``close`` runs the app's cleanup: the coalescer's
    aclose, then the manager's shutdown."""

    def __init__(self, app) -> None:
        from aiohttp import web
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app, access_log=None)
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.url = "http://127.0.0.1:%d" % self.runner.addresses[0][1]
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="serve-loop", daemon=True)
        self.thread.start()

    def call(self, fn):
        """Run ``fn()`` on the server's loop and return its result."""
        async def wrap():
            return fn()
        return asyncio.run_coroutine_threadsafe(wrap(), self.loop).result(60)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(300)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        if self.thread.is_alive():
            raise RuntimeError("the server loop did not stop")
        self.loop.close()
