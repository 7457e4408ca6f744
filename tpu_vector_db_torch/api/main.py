"""Server entrypoint: ``python -m tpu_vector_db_torch.api.main [development|production]``.

Parity with reference main.py:376-427 (dev vs prod runners, HOST/PORT env).
The prod path needs no workers=1 pin (reference main.py:395): concurrency
comes from asyncio + the manager's worker pool. The server runs on the
CUDA card; ``VDB_FORCE_CPU=1`` serves on the CPU instead.
"""

from __future__ import annotations

import logging
import os
import sys

from aiohttp import web

from tpu_vector_db_torch.api.app import create_app
from tpu_vector_db_torch.core.logging_config import setup_logging

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    mode = argv[0] if argv else os.environ.get("ENVIRONMENT", "development")
    os.environ["ENVIRONMENT"] = mode
    # the module-level auth config was built at import time, BEFORE the
    # argv mode landed in ENVIRONMENT — rebuild it so production REQUIRES
    # VECTOR_DB_API_KEY/ADMIN_KEY instead of generating dev keys
    from tpu_vector_db_torch.security.auth import reload_auth
    reload_auth()
    setup_logging(handler="json" if mode == "production" else None)

    host = os.environ.get("HOST", "127.0.0.1" if mode == "development"
                          else "0.0.0.0")
    port = int(os.environ.get("PORT", "8000"))
    app = create_app(redis_url=os.environ.get("REDIS_URL"))
    logger.info("starting tpu-vector-db (%s) on %s:%d", mode, host, port)
    web.run_app(app, host=host, port=port, access_log=None)


if __name__ == "__main__":
    main()
