"""Closed-loop REST users: ``clients`` users, each sending one
``POST /vectors/query`` (one vector of the pool, ``k``, no filter) and
the next when its reply has been read, spread over ``client_processes``
processes of ``client.py`` (no torch), whose
bodies are serialised before the window. ``lead_s`` seconds of the same
traffic run before the window opens; a request not answered within
``timeout_s`` fails.

A traffic file of this generator holds ``"generator": "rest_closed"``
and exactly the keys of ``KEYS``.
"""

from __future__ import annotations

import json

from benchmark_h100 import loadgen, window

# answers come back as JSON over HTTP (similarities to 6 decimals)
REST = True
KEYS = {"clients": int, "client_processes": int, "k": int,
        "lead_s": float, "timeout_s": float}


def warm_shapes(traffic: dict, config: dict) -> list[int]:
    """Coalesced flushes pad to powers of two up to the coalescer's
    batch."""
    return [1 << i for i in range(
        int(config["server"]["coalesce_batch"]).bit_length())]


def drive(*, manager, config: dict, traffic: dict, pool, seconds: float,
          tracer, **_) -> window.Window:
    """Serve the app, drive it from the client processes, return the
    window."""
    from benchmark_h100.server import TENANT, ServerThread
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.monitoring import get_registry
    from tpu_vector_db_torch.security.auth import reload_auth
    reload_auth()     # the keys of the configuration's deployment
    app = create_app(manager=manager)
    server = ServerThread(app)
    load = None
    k = int(traffic["k"])
    try:
        load = loadgen.RestLoad(server.url, config["server"]["api_key"],
                                TENANT, pool, traffic)
        load.wait_ready()
        hist = get_registry().histogram("http_request_duration_seconds")
        coal = app["coalescer"]

        def counters():
            snap = hist.snapshot()
            st = coal.get_stats() if coal is not None else None
            return (snap["sum"], snap["count"], st)
        t_start, t0, t_end = window.schedule(seconds,
                                             float(traffic["lead_s"]))
        load.go(t_start, t0, t_end)
        watch = window.HostWatch()
        window.sleep_until(t0)
        c0 = server.call(counters)
        watch.start()
        if tracer is not None:
            a, b = window.profiled_slice(t0, seconds)
            window.sleep_until(a)
            tracer.start_slice()
            window.sleep_until(b)
            tracer.stop_slice()
        window.sleep_until(t_end)
        c1 = server.call(counters)
        watch.stop()
        trace = None
        if c0[2] is not None:
            window.log(
                f"coalescer over the window: "
                f"{c1[2]['batches'] - c0[2]['batches']} flushes, by padded "
                "size " + json.dumps(
                    {b: n - c0[2]["batch_size_hist"].get(b, 0)
                     for b, n in c1[2]["batch_size_hist"].items()}))
        if tracer is not None:
            trace = {"http": {"sum_s": c1[0] - c0[0],
                              "count": c1[1] - c0[1]}}
            if c0[2] is not None:
                q = [st["coalesced_queries"]
                     + st["batch_size_hist"].get(1, 0) for st in (c0[2],
                                                                  c1[2])]
                trace["coalescer"] = {
                    "batches": c1[2]["batches"] - c0[2]["batches"],
                    "queries": q[1] - q[0]}
        records, busy = load.collect(float(traffic["timeout_s"]) + 60)
    finally:
        if load is not None:
            load.close()
        server.close()
    answers, lat_ms, done_ok, attempted, failed = window.rest_window(
        records, t0, t_end, k, float(traffic["timeout_s"]) * 1e3)
    notes = [
        "client processes' busy share over the window: "
        + ", ".join(f"{b:.4f}" for b in busy),
        "answers a second by 4 s slice: " + ", ".join(
            f"{r:.1f}" for r in window.rate_by_slice(
                [r[2] for r in records if r[3] == 200], t0, t_end))]
    return window.Window(t0, t_end, answers, lat_ms, done_ok, attempted,
                         failed, trace, notes)
