"""Readers-writer lock for the store's query/mutate split.

Appends write into the store's preallocated device buffers in place, and
a capacity change swaps the buffers for new ones, so a query must not run
while a mutation is in progress. Queries CAN run concurrently with each
other: a batch_query only reads host bookkeeping and launches read-only
kernels on the device stream.

Writer-preference: once a writer waits, new readers queue behind it, so
a sustained query stream cannot starve ingest.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    """threading-based readers-writer lock, writer-preference.

    Not reentrant in either direction: a thread holding write must not
    acquire read (the store's mutators never query through batch_query).
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
