"""Spans and counters along the query path, on while a torch profiler runs.

Tracing is on exactly while a ``torch.profiler`` (or
``torch.autograd.profiler``) profile is running in the process: every
site first reads ``torch.autograd.profiler._is_profiler_enabled``, the
process-wide flag the profiler sets when it starts and clears when it
stops, and does nothing more while it is False. (The thread-local
``torch._C._autograd._profiler_enabled()`` reads False in every thread
but the profiler's own, so it cannot be the test.) The benchmark's traced
slice and ``/debug/profile`` therefore trace, and nothing else does.

A span records its name, start and end (``time.perf_counter_ns``), the
wall clock at its start (the clock of the profiler's own events:
``trace_start_ns() + time_range.start * 1e3``), its thread, the request
id and the flush id it serves, the span that caused it, and a few
attributes (k, a flush's size, the store's route). The current span
travels in a context variable, so a child
finds its parent across ``await`` and, through ``carry``, into a worker
thread. Finished spans go to a bounded ring, with a count of those
dropped; beside it the tracer keeps, by name, the count, total time and
self time (the duration less what its child spans cover). The counter
``runtime.gc`` counts garbage collections and their pauses by generation
while tracing is on. ``summary`` and ``spans`` cover every profiled
period since the process started or since ``reset``. A period is a
little longer than the profile's own record: torch sets the flag before
its profiler's enable call and clears it after the disable call.
"""

from __future__ import annotations

import contextvars
import functools
import gc
import itertools
import json
import os
import threading
import time
from collections import deque
from threading import get_ident

import torch
import torch.autograd.profiler as _profiler

RING = 1 << 16          # finished spans kept; older ones are dropped
# a finished span's fields, in the order the ring keeps them (its
# attributes flat: key, value, key, value, ...)
RECORD = ("name", "id", "parent", "rid", "flush", "thread", "start_ns",
          "end_ns", "epoch_ns", "self_ns", "attrs")

_current: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_vector_db_torch_span", default=None)
_ids = itertools.count(1)
_FROM_CONTEXT = object()


def on() -> bool:
    """True while a profiler runs in the process."""
    return _profiler._is_profiler_enabled


class Span:
    """One open or finished span; ``finish`` ends it. ``attrs`` is flat
    (key, value, key, value, ...); ``_kids`` is () until a child opens
    and None once the span has ended."""

    __slots__ = ("name", "id", "parent", "rid", "flush", "thread", "start",
                 "end", "wall", "attrs", "_kids", "_token", "_rf")

    def finish(self, flush: int | None = None) -> None:
        """End the span; ``flush``: the flush that served it."""
        if flush is not None:
            self.flush = flush
        _TRACER.close(self, time.perf_counter_ns())

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc) -> None:
        # the record_function's end is stamped early in its exit, so the
        # span ends after it: the two then end within microseconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        _current.reset(self._token)
        _TRACER.close(self, end)


class _Off:
    """What a span site gets while tracing is off: does nothing."""

    __slots__ = ()
    id = rid = flush = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


OFF = _Off()


def _covered(kids: list, a: int, b: int) -> int:
    """Nanoseconds of [a, b] that the child spans ``kids`` cover (one
    still open covers up to b)."""
    if len(kids) == 1:
        k = kids[0]
        return max(0, min(b if k.end is None else k.end, b) - max(k.start, a))
    total, reach = 0, a
    for s, e in sorted((k.start, b if k.end is None else k.end)
                       for k in kids):
        s, e = max(s, reach), min(e, b)
        if e > s:
            total += e - s
            reach = e
    return total


class Tracer:
    """The ring of finished spans, the per-name aggregates and the gc
    counter. One a process (``_TRACER``), since the switch, the
    profiler's flag, is the process's. A span's close takes no lock: the
    ring's append is atomic, and each thread adds to aggregates of its
    own, which ``summary`` sums."""

    def __init__(self) -> None:
        self._ring: deque = deque(maxlen=RING)
        # by thread (``get_ident``): {name: [count, total ns, self ns]}
        self._aggs: dict[int, dict[str, list[int]]] = {}
        # by thread (``get_ident``): its native id, which torch's
        # profiler shows; by native id: the thread's name
        self._tids: dict[int, int] = {}
        self._threads: dict[int, str] = {}
        # gc callbacks run one at a time under the interpreter lock
        self._gc_start: int | None = None
        self._gc_count = [0, 0, 0]
        self._gc_pause_ns = [0, 0, 0]

    def open(self, name: str, parent, rid, flush: bool, attrs: tuple) -> Span:
        sp = Span()
        sp.wall = time.time_ns()
        sp.start = time.perf_counter_ns()
        if parent is _FROM_CONTEXT:
            parent = _current.get()
        sp.name, sp.id, sp.attrs = name, next(_ids), attrs
        sp._kids, sp._rf, sp.end = (), None, None
        if rid is not None or flush or parent is None:
            sp.parent, sp.rid = None, rid
            sp.flush = sp.id if flush else None
        else:
            sp.parent, sp.rid, sp.flush = parent.id, parent.rid, parent.flush
            kids = parent._kids
            if kids:
                kids.append(sp)
            elif kids is not None:    # None: the parent has ended
                parent._kids = [sp]
        tid = self._tids.get(get_ident())
        if tid is None:
            tid = self._tids[get_ident()] = threading.get_native_id()
            self._threads[tid] = threading.current_thread().name
        sp.thread = tid
        return sp

    def close(self, sp: Span, end: int) -> None:
        kids, sp._kids = sp._kids, None
        dur = end - sp.start
        own = dur - _covered(kids, sp.start, end) if kids else dur
        sp.end = end
        # the ring keeps flat tuples of strings and numbers, which the
        # collector stops tracking at its first pass: held spans must not
        # age into the old generation and bring on full collections
        self._ring.append((sp.name, sp.id, sp.parent, sp.rid, sp.flush,
                           sp.thread, sp.start, end, sp.wall, own,
                           sp.attrs))
        aggs = self._aggs.get(get_ident())
        if aggs is None:
            aggs = self._aggs[get_ident()] = {}
        agg = aggs.get(sp.name)
        if agg is None:
            agg = aggs[sp.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += own

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _profiler._is_profiler_enabled:
                self._gc_start = time.perf_counter_ns()
            return
        if self._gc_start is None:
            return
        gen = info["generation"]
        self._gc_count[gen] += 1
        self._gc_pause_ns[gen] += time.perf_counter_ns() - self._gc_start
        self._gc_start = None

    def summary(self) -> dict:
        total: dict[str, list[int]] = {}
        for aggs in list(self._aggs.values()):
            for name, v in list(aggs.items()):
                t = total.setdefault(name, [0, 0, 0])
                for i in range(3):
                    t[i] += v[i]
        kept = len(self._ring)
        return {
            "spans": {name: {"count": n, "total_s": dur / 1e9,
                             "self_s": own / 1e9}
                      for name, (n, dur, own) in sorted(total.items())},
            "counters": {"runtime.gc": {
                "collections": list(self._gc_count),
                "pause_s": [ns / 1e9 for ns in self._gc_pause_ns]}},
            # every finished span went to the ring once
            "kept": kept,
            "dropped": max(0, sum(v[0] for v in total.values()) - kept)}

    def spans(self) -> list[dict]:
        out = []
        for rec in list(self._ring):
            d = dict(zip(RECORD, rec))
            d["attrs"] = dict(zip(rec[-1][::2], rec[-1][1::2]))
            out.append(d)
        return out

    def reset(self) -> None:
        self._ring.clear()
        for aggs in list(self._aggs.values()):
            aggs.clear()
        self._gc_count = [0, 0, 0]
        self._gc_pause_ns = [0, 0, 0]


_TRACER = Tracer()
gc.callbacks.append(_TRACER.on_gc)


def start(name: str, *, parent=_FROM_CONTEXT) -> Span | None:
    """Open a span that some later call ``finish``es (in another task
    or thread, say); None while tracing is off, or when ``parent`` is
    ``OFF``. The parent is the current span unless given."""
    if not _profiler._is_profiler_enabled or parent is OFF:
        return None
    return _TRACER.open(name, parent, None, False, ())


def span(name: str, *, rid: str | None = None, flush: bool = False,
         host_only: bool = False, k=None, size=None):
    """``with span(...) as sp``: a span that is the current one inside
    the block, or ``OFF`` while tracing is off. ``rid``: the root of a
    request, with its id. ``flush``: the root of a coalescer flush, whose
    id is its own. ``host_only``: the block launches no kernel, so in a
    thread the profiler records it is also a
    ``torch.profiler.record_function``, which labels the device's idle
    gaps there (around a launch it would show on the device's timeline
    as device time). ``k``, ``size`` (a flush's queries): attributes,
    kept where not None."""
    if not _profiler._is_profiler_enabled:
        return OFF
    rf = None
    # the thread-local flag: is this thread one the profiler records?
    if host_only and torch._C._autograd._profiler_enabled():
        rf = _profiler.record_function(name)
        rf.__enter__()
    attrs = () if k is None else ("k", k)
    if size is not None:
        attrs += ("size", size)
    sp = _TRACER.open(name, _FROM_CONTEXT, rid, flush, attrs)
    sp._rf = rf
    return sp


def traced(name: str):
    """Decorator: the call is a ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def annotate(key: str, value) -> None:
    """Add the attribute ``key`` (``k``, ``route``) to the current span,
    while tracing is on."""
    if _profiler._is_profiler_enabled:
        sp = _current.get()
        if sp is not None:
            sp.attrs += (key, value)


def carry(fn, wait_name: str):
    """``fn`` to run in a worker thread inside the caller's context (its
    current span, so the request and flush ids), with a span
    ``wait_name`` from now until a worker starts it."""
    ctx = contextvars.copy_context()
    wait = start(wait_name)

    def run():
        if wait is not None:
            wait.finish()
        return ctx.run(fn)
    return run


def summary() -> dict:
    """By span name: count, total_s, self_s; the ``runtime.gc`` counter
    (collections and pause seconds by generation); spans kept in the
    ring and dropped from it."""
    return _TRACER.summary()


def spans() -> list[dict]:
    """The ring's finished spans, oldest first. ``start_ns``/``end_ns``
    are ``time.perf_counter_ns``; ``epoch_ns`` is the start on the
    profiler's clock (nanoseconds since the epoch), so a span lies at
    [epoch_ns, epoch_ns + end_ns - start_ns] there."""
    return _TRACER.spans()


def reset() -> None:
    _TRACER.reset()


def export_chrome(path: str, since_ns: int, until_ns: int,
                  base_ns: int = 0) -> int:
    """Write the spans that start in [since_ns, until_ns]
    (``perf_counter_ns``) as a Chrome trace: ``ts`` in microseconds
    since ``base_ns`` on the profiler's clock (the ``baseTimeNanoseconds``
    of torch's own Chrome trace, so both share a time base), one row a
    thread. Returns the number of spans written."""
    pid = os.getpid()
    names = dict(_TRACER._threads)
    events, threads = [], set()
    for rec in spans():
        if not since_ns <= rec["start_ns"] <= until_ns:
            continue
        threads.add(rec["thread"])
        events.append({
            "name": rec["name"], "cat": "vdb_span", "ph": "X",
            "pid": pid, "tid": rec["thread"],
            "ts": (rec["epoch_ns"] - base_ns) / 1e3,
            "dur": (rec["end_ns"] - rec["start_ns"]) / 1e3,
            "args": {"id": rec["id"], "parent": rec["parent"],
                     "rid": rec["rid"], "flush": rec["flush"],
                     **rec["attrs"]}})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": names.get(tid, str(tid))}}
            for tid in sorted(threads)]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)
    return len(events)
