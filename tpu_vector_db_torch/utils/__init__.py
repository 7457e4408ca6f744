"""Shared helpers: atomic writes, the store's file lock, input validation."""

from tpu_vector_db_torch.utils.fs import (  # noqa: F401
    ensure_directory,
    atomic_write_bytes,
    atomic_save_npz,
    FileLock,
)
from tpu_vector_db_torch.utils.validation import validate_vector_shape  # noqa: F401
