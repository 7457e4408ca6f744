"""What every traffic generator shares: the window's schedule, the
profiled slice, the host's record over the window, and the reduction of
the requests' records to what a run reports.

A generator (``traffic/<generator>.py``) drives the window and returns
``Window``: its bounds, the answers to judge, every latency of the
requests sent in it, the queries answered in it, and what the traced run
read. ``run.py`` does the rest.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass, field

LEAD_GAP_S = 0.2      # from "go" to the first request sent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def schedule(seconds: float, lead_s: float):
    """(t_start, t0, t_end) on ``time.monotonic``: the traffic starts at
    t_start, the window is [t0, t_end)."""
    now = time.monotonic()
    t_start = now + LEAD_GAP_S
    t0 = t_start + lead_s
    return t_start, t0, t0 + seconds


def profiled_slice(t0: float, seconds: float) -> tuple[float, float]:
    """The profiled slice: from 35% of the window, for 30% of it, at
    most 5 s."""
    a = t0 + 0.35 * seconds
    return a, a + min(0.30 * seconds, 5.0)


class HostWatch:
    """What the host did over the window, for the log: this process's
    CPU seconds and its garbage collections and their pauses."""

    def __init__(self) -> None:
        self.pauses: dict[int, list[float]] = {0: [], 1: [], 2: []}
        self._t = {}

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._t[info["generation"]] = time.perf_counter()
        elif info["generation"] in self._t:
            self.pauses[info["generation"]].append(
                time.perf_counter() - self._t.pop(info["generation"]))

    def start(self) -> None:
        gc.callbacks.append(self._gc)
        self._cpu0 = os.times()
        self._w0 = time.monotonic()

    def stop(self) -> None:
        gc.callbacks.remove(self._gc)
        wall = time.monotonic() - self._w0
        cpu = os.times()
        used = (cpu.user + cpu.system - self._cpu0.user - self._cpu0.system)
        log(f"host over the window: this process {used / wall:.3f} CPUs; "
            "gc pauses by generation "
            + ", ".join(f"{g}: {len(v)} / {sum(v) * 1e3:.1f} ms "
                        f"(max {max(v, default=0) * 1e3:.1f})"
                        for g, v in self.pauses.items()))


def rate_by_slice(done_times, t0: float, t_end: float,
                  width: float = 4.0) -> list[float]:
    """Completions a second in ``round(window / width)`` equal slices of
    the window."""
    n = max(1, int(round((t_end - t0) / width)))
    width = (t_end - t0) / n
    counts = [0] * n
    for t in done_times:
        if t0 <= t < t_end:
            counts[min(n - 1, int((t - t0) / width))] += 1
    return [c / width for c in counts]


@dataclass
class Window:
    """A generator's account of the window. ``lat_ms``: every request
    sent in [t0, t_end), a failed one at no less than its timeout;
    ``done_ok``: queries answered and done in the window; ``trace``:
    the traced run's counter deltas (None untraced)."""
    t0: float
    t_end: float
    answers: object
    lat_ms: list[float]
    done_ok: int
    attempted: int
    failed: int
    trace: dict | None = None
    notes: list[str] = field(default_factory=list)


def rest_window(records, t0: float, t_end: float, k: int,
                timeout_ms: float):
    """The REST window from the clients' records [qidx, t_send, t_done,
    status, ids, sims]: (answers to judge: every 200 reply recorded;
    latencies (ms) of the requests sent in [t0, t_end), a failed one at
    no less than the client's timeout, beyond every limit; queries
    answered with 200 and done in [t0, t_end); requests sent in the
    window; those of them that failed)."""
    from benchmark_h100 import verdict
    answers = verdict.Answers(k)
    lat_ms, done_ok, attempted, failed = [], 0, 0, 0
    for qidx, t_send, t_done, status, ids, sims in records:
        ok = status == 200
        if ok:
            answers.add(qidx, ids, sims)
            done_ok += int(t_done < t_end)
        if t0 <= t_send < t_end:
            attempted += 1
            failed += int(not ok)
            dt = (t_done - t_send) * 1e3
            lat_ms.append(dt if ok else max(timeout_ms, dt))
    answers.failed = failed
    return answers, lat_ms, done_ok, attempted, failed


def library_window(times, kept, failed: int, t0: float, t_end: float,
                   k: int):
    """The library window from the calls [t_send, t_done, n_queries]:
    as ``rest_window``, a call's queries counting toward throughput, its
    wall time one latency; ``kept`` [(pool idx, result)] are judged
    (a failed call's result is None)."""
    from benchmark_h100 import verdict
    answers = verdict.Answers(k)
    lat_ms, done_ok, attempted = [], 0, 0
    for t_send, t_done, n_q in times:
        done_ok += n_q * int(t_done < t_end)
        if t0 <= t_send < t_end:
            attempted += 1
            lat_ms.append((t_done - t_send) * 1e3)
    for idx, res in kept:
        if res is not None:
            for qi, (ids, sims, _meta) in zip(idx, res):
                answers.add(int(qi), ids, sims)
    answers.failed = failed
    return answers, lat_ms, done_ok, attempted, failed
