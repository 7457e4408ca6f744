"""Filesystem helpers: atomic writes and a cross-process lock.

The reference persisted with plain ``mx.savez`` (no atomicity — a crash
mid-write corrupts the store, which its loader then silently drops,
optimized_vector_store.py:237-239) and shipped an unused ``filelock`` helper
(utils.py:21-25). Here every write is tmp-file + ``os.replace`` (atomic on
POSIX) and the lock is stdlib fcntl, actually used by the store.
"""

from __future__ import annotations

import io
import os
import fcntl
from pathlib import Path

import numpy as np


def ensure_directory(path: str | os.PathLike) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> None:
    """Write-then-rename so readers never observe a torn file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_save_npz(path: str | os.PathLike, **arrays: np.ndarray) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())


class FileLock:
    """Advisory cross-process lock on ``<dir>/.store.lock`` (fcntl flock).

    Context manager; re-entrant within a process is NOT needed because the
    store holds its own RLock and takes this only around disk transactions.
    """

    def __init__(self, directory: str | os.PathLike,
                 name: str = ".store.lock") -> None:
        self._path = Path(directory) / name
        self._fd: int | None = None

    def __enter__(self) -> "FileLock":
        ensure_directory(self._path.parent)
        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
