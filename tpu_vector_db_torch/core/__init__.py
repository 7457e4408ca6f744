"""Core infrastructure: structured logging (counterpart of reference
core/logging_config.py — wired for real here, with its missing-import bug
gone)."""

from tpu_vector_db_torch.core.logging_config import (  # noqa: F401
    JsonFormatter,
    get_logger_with_extra,
    setup_logging,
)
