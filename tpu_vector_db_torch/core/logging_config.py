"""Structured JSON logging.

Capability parity with reference core/logging_config.py:32-134 (dictConfig
with JSON + console handlers, env overrides LOG_LEVEL / APP_LOG_LEVEL /
LOG_HANDLER, a JsonFormatter emitting
timestamp/level/logger/module/function/line/thread/process + extras +
exception text, and a logger adapter). The reference's missing
``import threading`` bug (:92) does not recur — request-scoped fields ride a
contextvar instead of a thread-local, which also works under asyncio.
"""

from __future__ import annotations

import contextvars
import json
import logging
import logging.config
import os
import time

# request-scoped structured fields (request_id, user_id, ...) — set by the
# API middleware, attached to every record emitted while handling the request
request_context: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "request_context", default={})

_STANDARD_ATTRS = set(vars(logging.makeLogRecord({})))


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "module": record.module,
            "function": record.funcName,
            "line": record.lineno,
            "thread": record.threadName,
            "process": record.process,
            "message": record.getMessage(),
        }
        payload.update(request_context.get({}))
        for key, value in vars(record).items():
            if key not in _STANDARD_ATTRS and key != "message":
                payload[key] = value
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str, ensure_ascii=False)


def setup_logging(level: str | None = None,
                  handler: str | None = None) -> None:
    """Configure root + framework loggers. handler: 'json' or 'console'."""
    level = (level or os.environ.get("APP_LOG_LEVEL")
             or os.environ.get("LOG_LEVEL") or "INFO").upper()
    handler = (handler or os.environ.get("LOG_HANDLER") or "console").lower()

    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "json": {"()": JsonFormatter},
            "simple": {
                "format": "%(asctime)s %(levelname)-7s %(name)s: %(message)s",
            },
        },
        "handlers": {
            "stdout": {
                "class": "logging.StreamHandler",
                "stream": "ext://sys.stdout",
                "formatter": "json" if handler == "json" else "simple",
            },
        },
        "root": {"level": level, "handlers": ["stdout"]},
        "loggers": {
            "tpu_vector_db_torch": {"level": level, "propagate": True},
            "aiohttp.access": {"level": "WARNING"},
            "torch": {"level": "WARNING"},
        },
    })


def get_logger_with_extra(name: str, **extra) -> logging.LoggerAdapter:
    """Adapter that stamps fixed extra fields on every record."""
    return logging.LoggerAdapter(logging.getLogger(name), extra)
