"""Pieces the traffic generators (``traffic/<generator>.py``) share.

* ``RestLoad``: the processes of ``client.py`` (closed-loop REST users,
  no torch), fed their share of the pool at set-up;
* ``lib_loop``: back-to-back in-process calls, walking the pool.

Both walk the query pool in its order and start again at its end. A
request is timed from its send to its last byte read (the call's wall
time for the library).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CLIENT = Path(__file__).resolve().parent / "client.py"


class RestLoad:
    """The client processes of one run, spawned and fed at set-up."""

    def __init__(self, url: str, key: str, tenant: tuple[str, str],
                 pool: np.ndarray, traffic: dict) -> None:
        n_users = int(traffic["clients"])
        n_proc = max(1, min(int(traffic["client_processes"]), n_users))
        self.procs = []
        for p in range(n_proc):
            users = list(range(p, n_users, n_proc))
            idx = [i for i in range(len(pool)) if i % n_users in users]
            hdr = {"url": url, "key": key, "user_id": tenant[0],
                   "model_id": tenant[1], "k": int(traffic["k"]),
                   "users": users, "n_users": n_users, "pool": len(pool),
                   "indices": idx, "dim": int(pool.shape[1]),
                   "timeout_s": float(traffic["timeout_s"])}
            proc = subprocess.Popen([sys.executable, str(CLIENT)],
                                    stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE)
            proc.stdin.write(json.dumps(hdr).encode() + b"\n")
            proc.stdin.write(np.ascontiguousarray(pool[idx],
                                                  np.float32).tobytes())
            proc.stdin.flush()
            self.procs.append(proc)

    def wait_ready(self) -> None:
        for proc in self.procs:
            line = proc.stdout.readline()
            if line.strip() != b"ready":
                raise RuntimeError(f"a client process did not start: "
                                   f"{line!r} (exit {proc.poll()})")

    def go(self, t_start: float, t0: float, t_end: float) -> None:
        msg = f"go {t_start!r} {t0!r} {t_end!r}\n".encode()
        for proc in self.procs:
            proc.stdin.write(msg)
            proc.stdin.flush()

    def collect(self, timeout_s: float) -> tuple[list, list[float]]:
        """Every process's records and busy share; waits for each to
        end (``kill`` after ``timeout_s``)."""
        records, busy = [], []
        for proc in self.procs:
            line = proc.stdout.readline()
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if not line:
                raise RuntimeError(f"a client process returned nothing "
                                   f"(exit {proc.returncode})")
            got = json.loads(line)
            records.extend(got["records"])
            busy.append(got["busy_share"])
        return records, busy

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def lib_batches(pool: np.ndarray, batch: int):
    """Endless (pool indices, queries) batches walking the pool."""
    n, i = len(pool), 0
    while True:
        idx = (np.arange(i, i + batch) % n)
        yield idx, (pool[i:i + batch] if i + batch <= n else pool[idx])
        i = (i + batch) % n


def lib_loop(call, pool: np.ndarray, batch: int, k: int, t0: float,
             t_end: float, keep, on_tick=None):
    """Back-to-back ``call(queries, k)`` from now until ``t_end``
    (``time.monotonic``). Calls done from ``t0`` are recorded; those
    whose number (counted from the first) is in ``keep`` keep their
    answers.
    ``on_tick(now)`` runs between calls. Returns (times, kept) with
    times [(t_send, t_done, n_queries)] and kept [(pool idx, result)]."""
    batches = lib_batches(pool, batch)
    times, kept, n = [], [], 0
    while True:
        now = time.monotonic()
        if on_tick is not None:
            on_tick(now)
        if now >= t_end:
            return times, kept
        idx, qs = next(batches)
        t_send = time.monotonic()
        res = call(qs, k)
        t_done = time.monotonic()
        if t_done >= t0:
            times.append((t_send, t_done, len(idx)))
            if n in keep:
                kept.append((idx, res))
            n += 1
