"""The port's tracer (``tpu_vector_db_torch/monitoring/tracing.py``) on the
CPU: spans only while a torch profiler runs, their ids joined across the
event loop and a worker thread, self time, the profiler's clock, the gc
counter, the benchmark's readers of them, and the server's exporters.
``profile(activities=[CPU])`` turns tracing on; no card is needed."""

import asyncio
import gc
import json
import threading
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark_h100 import run as bench_run
from tpu_vector_db_torch.monitoring import tracing

API_KEY = "tvdb_test_api_key_0123456789abc"
ADMIN_KEY = "tvdb_admin_test_key_0123456789"
AUTH = {"Authorization": f"Bearer {API_KEY}"}
ADMIN = {"Authorization": f"Bearer {ADMIN_KEY}"}
DIM = 32
FLAT = {"user_id": "tr", "model_id": "flat"}
IVF = {"user_id": "tr", "model_id": "ivf"}
# the benchmark's readers of the tracer (benchmark_h100/metrics/)
READERS = ["api.decode_ms.load", "api.encode_ms.load",
           "coalescer.wait_ms.load", "coalescer.resume_ms.load",
           "manager.executor_wait_ms.load", "store.scan_ms",
           "store.format_ms", "runtime.gc_pause_share",
           "api.decode_ms.serial", "api.encode_ms.serial",
           "coalescer.wait_ms.serial", "index.search_ms.serial"]
# what the benchmark's readers take from the traced run: the profiled
# slice's record
SLICE = {"device": {"window_s": 1.0, "busy_s": 0.0}}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def make_client(tmp_path) -> TestClient:
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.batcher import QueryCoalescer
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    manager = VectorStoreManager(base_path=tmp_path / "stores", device="cpu",
                                 errors=ErrorHandler(tmp_path / "logs"))
    app = create_app(manager=manager)
    app["coalescer"] = QueryCoalescer(manager, window_ms=2, max_batch=8)
    return TestClient(TestServer(app))


async def fill(client, rows, tenant=FLAT, **store) -> None:
    r = await client.post("/admin/create_store", headers=ADMIN,
                          json={**tenant, "dimension": DIM, **store})
    assert r.status == 201, await r.text()
    r = await client.post("/vectors/add", headers=AUTH,
                          json={**tenant, "vectors": rows.tolist()})
    assert r.status == 200, await r.text()


async def query(client, vec, tenant=FLAT, k=5):
    r = await client.post("/vectors/query", headers=AUTH,
                          json={**tenant, "query": vec.tolist(), "k": k})
    assert r.status == 200, await r.text()
    return await r.json()


def rows_of(n, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_no_profiler_records_nothing(tmp_path):
    rows = rows_of(64)

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)
            await query(client, rows[5])
    asyncio.run(go())
    assert not tracing.on()
    assert tracing.spans() == []
    s = tracing.summary()
    assert s["spans"] == {} and s["kept"] == 0 and s["dropped"] == 0
    assert s["counters"]["runtime.gc"]["collections"] == [0, 0, 0]


def test_an_untraced_query_joins_its_lane_as_a_plain_pair(tmp_path):
    """With no profiler running, a lane holds (vector, future) pairs and
    the coalescer keeps no span holder for any waiter."""
    rows = rows_of(64)
    seen = []

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)
            co = client.server.app["coalescer"]
            run = co._run

            async def spy(key, items):
                seen.append([type(it) for it in items])
                assert co._traced == {}
                await run(key, items)
            co._run = spy
            await asyncio.gather(*[query(client, rows[i]) for i in range(4)])
            assert co._traced == {}
    asyncio.run(go())
    assert seen and all(t is tuple for ts in seen for t in ts)
    assert tracing.spans() == []


def test_concurrent_traced_queries_share_one_flush(tmp_path):
    """Eight queries at once under a profiler fill one flush of eight:
    each wait carries that flush's id and its own request's id, and no
    span holder outlives its query."""
    rows = rows_of(64)

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)
            # the eighth query, not the window's timer, starts the flush
            client.server.app["coalescer"].window_s = 60.0
            tracing.reset()
            with cpu_profile():
                bodies = await asyncio.gather(
                    *[query(client, rows[i]) for i in range(8)])
            assert [b["results"][0]["index"] for b in bodies] == \
                list(range(8))
            assert client.server.app["coalescer"]._traced == {}
    asyncio.run(go())
    spans = by_name(tracing.spans())
    flushes = spans["coalescer.flush"]
    assert [f["attrs"]["size"] for f in flushes] == [8]
    waits = spans["coalescer.wait"]
    assert len(waits) == 8
    assert {w["flush"] for w in waits} == {flushes[0]["flush"]}
    rids = {r["rid"] for r in spans["api.request"]}
    assert len(rids) == 8 and {w["rid"] for w in waits} == rids
    assert len(spans["coalescer.resume"]) == 8


def test_one_coalesced_query_joins_its_spans(tmp_path):
    """One POST /vectors/query through the coalescer: every stage's span,
    the request's under its request id on the loop thread, the flush's
    under its flush id on a worker thread, joined by the wait's flush
    id."""
    rows = rows_of(64)

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)
            tracing.reset()
            with cpu_profile():
                body = await query(client, rows[7])
            assert body["results"][0]["index"] == 7
            return client.server.app["manager"]
    asyncio.run(go())
    spans = by_name(tracing.spans())
    want = {"api.request", "api.decode", "coalescer.query", "coalescer.wait",
            "coalescer.resume", "coalescer.flush", "manager.executor_wait",
            "store.batch_query", "store.scan", "store.format", "api.encode"}
    assert want <= set(spans)
    one = {n: spans[n][-1] for n in want}
    rid = one["api.request"]["rid"]
    assert rid and len(rid) == 16
    for n in ("api.decode", "coalescer.query", "coalescer.wait",
              "coalescer.resume", "api.encode"):
        assert one[n]["rid"] == rid, n
    fid = one["coalescer.flush"]["flush"]
    assert fid == one["coalescer.flush"]["id"]
    for n in ("coalescer.wait", "manager.executor_wait", "store.batch_query",
              "store.scan", "store.format"):
        assert one[n]["flush"] == fid, n
    # parents: the request's tree and the flush's tree
    ids = {n: one[n]["id"] for n in want}
    assert one["api.request"]["parent"] is None
    assert one["coalescer.flush"]["parent"] is None
    assert one["api.decode"]["parent"] == ids["api.request"]
    assert one["coalescer.query"]["parent"] == ids["api.request"]
    assert one["coalescer.wait"]["parent"] == ids["coalescer.query"]
    assert one["coalescer.resume"]["parent"] == ids["coalescer.query"]
    assert one["store.batch_query"]["parent"] == ids["coalescer.flush"]
    assert one["store.scan"]["parent"] == ids["store.batch_query"]
    assert one["store.format"]["parent"] == ids["store.batch_query"]
    # two threads: the event loop's and a worker's
    loop_tid = one["api.request"]["thread"]
    assert one["coalescer.flush"]["thread"] == loop_tid
    assert one["store.batch_query"]["thread"] != loop_tid
    assert one["store.scan"]["thread"] == one["store.batch_query"]["thread"]
    assert one["store.batch_query"]["attrs"]["route"] == "flat"
    assert one["coalescer.flush"]["attrs"]["size"] == 1
    # the wait ends where the flush starts; the resume starts after the
    # flush's store call
    assert one["coalescer.wait"]["end_ns"] <= \
        one["coalescer.flush"]["start_ns"] + 1_000_000
    assert one["coalescer.resume"]["start_ns"] >= \
        one["store.batch_query"]["end_ns"]


def test_an_ivf_store_query_records_the_index_search(tmp_path):
    from tpu_vector_db_torch.store.config import VectorStoreConfig
    from tpu_vector_db_torch.store.vector_store import TorchVectorStore
    store = TorchVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=DIM, enable_ann=True, persist_mode="off",
        ann_params={"index_type": "ivf", "n_clusters": 8, "nprobe": 8}),
        device="cpu")
    rows = rows_of(800)
    store.add_vectors(rows)
    tracing.reset()
    with cpu_profile():
        out = store.batch_query(rows[:2], k=4)
    assert [r[0][0] for r in out] == [0, 1]
    spans = by_name(tracing.spans())
    assert {"store.batch_query", "index.search", "store.format"} <= set(spans)
    assert "store.scan" not in spans
    bq = spans["store.batch_query"][-1]
    assert bq["attrs"]["route"] == "ivf"
    assert spans["index.search"][-1]["parent"] == bq["id"]
    assert spans["index.search"][-1]["attrs"]["k"] == 4


def test_self_time_is_duration_less_child_coverage():
    with cpu_profile():
        with tracing.span("t.outer") as outer:
            time.sleep(0.002)
            with tracing.span("t.child"):
                time.sleep(0.003)
            # a child started here, ended past the parent's end: only its
            # part inside the parent counts
            late = tracing.start("t.late")
            time.sleep(0.001)
        time.sleep(0.002)
        late.finish()
        assert outer.parent is None
    spans = by_name(tracing.spans())
    o, c = spans["t.outer"][0], spans["t.child"][0]
    lt = spans["t.late"][0]
    inside = o["end_ns"] - lt["start_ns"]
    assert o["self_ns"] == (o["end_ns"] - o["start_ns"]) \
        - (c["end_ns"] - c["start_ns"]) - inside
    assert c["self_ns"] == c["end_ns"] - c["start_ns"]
    s = tracing.summary()["spans"]
    assert s["t.outer"]["count"] == 1
    assert s["t.outer"]["self_s"] == pytest.approx(o["self_ns"] / 1e9)
    assert s["t.child"]["total_s"] == pytest.approx(
        (c["end_ns"] - c["start_ns"]) / 1e9)


def test_a_span_on_the_profilers_clock_meets_its_record_function():
    """A main-thread span emitted as a record_function, moved to the
    profiler's clock (``epoch_ns``), lies within 50 us of the
    profiler's own event for it at both ends (the median of five, so
    that a preempted one does not decide)."""
    with cpu_profile() as prof:
        with record_function("t.warm"):   # the first one pays set-up
            pass
        for _ in range(5):
            with tracing.span("t.probe", host_only=True):
                time.sleep(0.002)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name == "t.probe"),
                    key=lambda e: e.time_range.start)
    recs = by_name(tracing.spans())["t.probe"]
    assert len(events) == len(recs) == 5
    gaps_start, gaps_end = [], []
    for evt, rec in zip(events, recs):
        ours = rec["epoch_ns"]
        gaps_start.append(abs(ours - (base + evt.time_range.start * 1e3)))
        gaps_end.append(abs(ours + rec["end_ns"] - rec["start_ns"]
                            - (base + evt.time_range.end * 1e3)))
    assert np.median(gaps_start) < 50_000, gaps_start
    assert np.median(gaps_end) < 50_000, gaps_end


def test_a_collection_under_tracing_counts_one_pause():
    enabled = gc.isenabled()
    gc.disable()
    try:
        gc.collect()                      # off: not counted
        with cpu_profile():
            gc.collect()
        gc.collect()
    finally:
        if enabled:
            gc.enable()
    g = tracing.summary()["counters"]["runtime.gc"]
    assert g["collections"] == [0, 0, 1]
    assert g["pause_s"][2] > 0 and g["pause_s"][:2] == [0.0, 0.0]


def test_another_thread_sees_the_profilers_process_wide_flag():
    """The switch is ``torch.autograd.profiler._is_profiler_enabled``, a
    private flag: it must read True from a thread the profiler does not
    run in, and False after it stops."""
    import torch.autograd.profiler as P
    seen = []

    def look():
        seen.append((P._is_profiler_enabled, tracing.on()))
    with cpu_profile():
        t = threading.Thread(target=look)
        t.start()
        t.join(10)
    assert not t.is_alive()
    t = threading.Thread(target=look)
    t.start()
    t.join(10)
    assert seen == [(True, True), (False, False)]


async def record_a_slice(client, rows) -> None:
    """One traced slice that every reader finds something in: a flat
    and an IVF query through the coalescer, and a collection."""
    with cpu_profile():
        await query(client, rows[9])
        await query(client, rows[11], tenant=IVF)
        gc.collect()


@pytest.mark.parametrize("name", READERS)
def test_each_span_reader_reads_a_slice_and_nothing_else(name, tmp_path):
    rows = rows_of(800)
    read = bench_run.reader(name)

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows[:64])
            await fill(client, rows, tenant=IVF, index_type="ivf",
                       ann_params={"n_clusters": 8, "nprobe": 8})
            tracing.reset()
            assert read(SLICE) is None
            await record_a_slice(client, rows)
    asyncio.run(go())
    value = read(SLICE)
    assert isinstance(value, float) and value > 0, value
    assert read({}) is None          # no profiled slice
    tracing.reset()
    assert read(SLICE) is None


def test_debug_profile_writes_the_spans_beside_the_torch_trace(tmp_path):
    rows = rows_of(64)
    out = tmp_path / "trace"

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)

            async def queries():
                await asyncio.sleep(0.1)
                for i in range(3):
                    await query(client, rows[i])
            r, _ = await asyncio.gather(
                client.post("/debug/profile", json={
                    "duration_ms": 1500, "trace_dir": str(out)}),
                queries())
            assert r.status == 200, await r.text()
            return await r.json()
    body = asyncio.run(go())
    torch_trace = json.loads(open(body["trace"]).read())
    ours = json.loads(open(body["spans"]).read())
    assert ours["baseTimeNanoseconds"] == torch_trace["baseTimeNanoseconds"]
    names = {e["name"] for e in ours["traceEvents"] if e["ph"] == "X"}
    assert {"api.request", "coalescer.flush", "store.scan"} <= names
    assert body["span_count"] == sum(e["ph"] == "X"
                                     for e in ours["traceEvents"])
    threads = {e["args"]["name"] for e in ours["traceEvents"]
               if e["ph"] == "M"}
    assert len(threads) >= 2
    # on the torch trace's time base: our spans fall inside its span
    ts = [e["ts"] for e in torch_trace["traceEvents"] if "ts" in e]
    for e in ours["traceEvents"]:
        if e["ph"] == "X":
            assert min(ts) - 1e3 <= e["ts"] <= max(ts) + 1e3


def test_stats_and_health_read_the_tracer_and_the_registry(tmp_path):
    from tpu_vector_db_torch.monitoring import get_registry
    rows = rows_of(64)

    async def go():
        async with make_client(tmp_path) as client:
            await fill(client, rows)
            with cpu_profile():
                await query(client, rows[1])
            r = await client.get("/performance/stats", headers=AUTH)
            stats = await r.json()
            hist = get_registry().histogram(
                "http_request_duration_seconds").snapshot()
            r = await client.get("/health")
            return stats, hist, (await r.json())["requests"]
    stats, hist, requests = asyncio.run(go())
    assert stats["tracing"]["spans"]["api.request"]["count"] == 1
    assert "coalescer" in stats
    assert requests["total"] == hist["count"] >= 3
    assert requests["avg_ms"] == round(hist["sum"] / hist["count"] * 1e3, 2)
