"""One in-process caller, closed loop: back-to-back
``TorchVectorStore.batch_query`` of ``batch`` pool queries at ``k``,
walking the pool in its order. A call is timed by its wall time and
counts its ``batch`` queries. ``warm_calls`` calls warm the shape at
set-up; ``lead_s`` seconds of calls run before the window opens; a
share ``judge_share`` of the window's calls, drawn from the seed, keep
their answers for the judge.

A traffic file of this generator holds ``"generator": "lib_closed"``
and exactly the keys of ``KEYS``.
"""

from __future__ import annotations

import numpy as np

from benchmark_h100 import datagen, loadgen, window

# answers come back as JSON over HTTP (similarities to 6 decimals)
REST = False
KEYS = {"batch": int, "k": int, "lead_s": float, "warm_calls": int,
        "judge_share": float}


def warm_shapes(traffic: dict, config: dict) -> list[int]:
    return [int(traffic["batch"])]


def drive(*, store, traffic: dict, pool, seconds: float, tracer,
          seed: int, **_) -> window.Window:
    k, batch = int(traffic["k"]), int(traffic["batch"])
    failed = [0]

    def call(qs, k):
        try:
            return store.batch_query(qs, k=k)
        except Exception as exc:  # noqa: BLE001 — a failed call counts
            window.log(f"batch_query failed: {exc!r}")
            failed[0] += 1
            return None
    # the calls whose answers are judged: a share drawn from the seed
    rng = np.random.default_rng(datagen.derive_seed(seed, "keep"))
    keep = set(np.flatnonzero(rng.random(1 << 20)
                              < float(traffic["judge_share"])).tolist())
    for _ in range(int(traffic["warm_calls"])):
        store.batch_query(pool[:batch], k=k)
    t_start, t0, t_end = window.schedule(seconds, float(traffic["lead_s"]))
    window.sleep_until(t_start)
    state = {"phase": 0, "watching": False}
    watch = window.HostWatch()
    a, b = window.profiled_slice(t0, seconds)

    def on_tick(now):
        if not state["watching"] and now >= t0:
            watch.start()
            state["watching"] = True
        if tracer is None:
            return
        if state["phase"] == 0 and now >= a:
            tracer.start_slice()
            state["phase"] = 1
        elif state["phase"] == 1 and now >= b:
            tracer.stop_slice()
            state["phase"] = 2
    times, kept = loadgen.lib_loop(call, pool, batch, k, t0, t_end, keep,
                                   on_tick)
    if state["watching"]:
        watch.stop()
    if tracer is not None and state["phase"] == 1:
        tracer.stop_slice()
    answers, lat_ms, done_ok, attempted, failed_n = window.library_window(
        times, kept, failed[0], t0, t_end, k)
    notes = ["calls a second by 4 s slice: " + ", ".join(
        f"{r:.1f}" for r in window.rate_by_slice([t[1] for t in times],
                                                 t0, t_end))]
    return window.Window(t0, t_end, answers, lat_ms, done_ok, attempted,
                         failed_n, {} if tracer is not None else None,
                         notes)
