"""The open-loop REST generator (``traffic/rest_open_loop.py``) and its
client process: the arrivals come from the seed alone, and a request is
timed from its scheduled arrival, so a sender that falls behind shows as
latency."""

import asyncio
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark_h100 import run, window

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ROOT / "benchmark_h100" / "traffic"
BENCH = run.load_bench()
CELL = "flat768.rest-open-k10"


def load(name):
    spec = importlib.util.spec_from_file_location("t_" + name,
                                                  TRAFFIC / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cells_traffic_is_the_open_loop_generator():
    _, _, traffic = run.cell_files(BENCH, CELL)
    assert traffic["generator"] == "rest_open_loop"
    assert run.generator(traffic).REST


def test_the_same_seed_draws_the_same_arrivals():
    gen = load("rest_open_loop")
    a = gen.arrivals(2**31 + 5, 640.0, 52.0)
    b = gen.arrivals(2**31 + 5, 640.0, 52.0)
    c = gen.arrivals(2**31 + 6, 640.0, 52.0)
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)
    assert (np.diff(a) > 0).all() and 0 <= a[0] and a[-1] < 52.0
    # a Poisson process at 640 a second: 33,280 arrivals expected
    assert abs(len(a) - 640 * 52) < 5 * np.sqrt(640 * 52)
    gaps = np.diff(a)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)


def test_latency_runs_from_the_schedule_when_the_sender_stalls():
    """The first reply blocks the client's event loop for 60 ms: the
    arrivals due meanwhile go out late, and each is timed from its due
    time, so the stall shows in the latency of every one of them."""
    client = load("rest_open_loop_client")
    stall = 0.06

    async def send(qidx):
        if qidx == 0:
            time.sleep(stall)          # blocks the loop, as a slow host
        await asyncio.sleep(0.001)
        return 200, b"{}"

    async def main():
        start = time.monotonic() + 0.02
        due = [start + 0.005 * i for i in range(20)]
        out = await client.open_loop(send, list(zip(due, range(20))),
                                     t0=start)
        return due, out

    due, (records, late) = asyncio.run(main())
    assert sorted(r[0] for r in records) == list(range(20))
    by_q = {r[0]: r for r in records}
    for q in range(20):
        assert by_q[q][1] == due[q]
    # the arrivals due during the stall went out late, and their
    # latency covers the wait
    stalled = [q for q in range(1, 20) if due[q] < due[0] + stall]
    assert len(stalled) >= 8
    assert max(late) >= stall * 0.5
    recs = [[q, t_due, t_done, status, [], []]
            for q, t_due, t_done, status, _ in records]
    _, lat_ms, done_ok, attempted, failed = window.rest_window(
        recs, due[0], due[-1] + 1.0, 10, 30e3)
    assert attempted == 20 and failed == 0 and done_ok == 20
    for q in stalled:
        assert (by_q[q][2] - due[q]) * 1e3 >= 1.0
    assert sorted(lat_ms) == sorted((r[2] - r[1]) * 1e3 for r in records)
    assert max(lat_ms) >= (due[0] + stall - due[stalled[-1]]) * 1e3


def test_an_arrival_past_the_cap_fails():
    """With two requests in flight and a cap of 2, the arrivals due
    before either answers are not sent and fail at once; once one has
    answered the next goes out."""
    client = load("rest_open_loop_client")
    sent = []

    async def send(qidx):
        sent.append(qidx)
        await asyncio.sleep(0.05)
        return 200, b"{}"

    async def main():
        start = time.monotonic() + 0.02
        due = [start + 0.002 * i for i in range(6)] + [start + 0.2]
        return await client.open_loop(send, list(zip(due, range(7))),
                                      t0=start, cap=2)

    records, _ = asyncio.run(main())
    status = {r[0]: r[3] for r in records}
    assert sent == [0, 1, 6]
    assert status == {0: 200, 1: 200, 2: client.OVER_CAP,
                      3: client.OVER_CAP, 4: client.OVER_CAP,
                      5: client.OVER_CAP, 6: 200}
    recs = [[q, t_due, t_done, st, [], []]
            for q, t_due, t_done, st, _ in records]
    _, _, done_ok, attempted, failed = window.rest_window(
        recs, min(r[1] for r in records), 10 ** 9, 10, 30e3)
    assert (attempted, failed, done_ok) == (7, 4, 3)


def test_the_open_loop_client_imports_no_torch():
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('c', "
            f"{str(TRAFFIC / 'rest_open_loop_client.py')!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'tpu_vector_db', 'tpu_vector_db_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
