"""An open-loop REST client process, no torch.

Started by ``rest_open_loop.OpenLoad`` with pipes on stdin and stdout:

1. stdin: one JSON header line (url, key, tenant, k, the pool indices
   it was sent and their dim, timeout, ``max_in_flight``, and its
   arrivals: ``due``, seconds from the traffic's start, and ``queries``,
   the pool index each asks), then the f32 bytes of those pool queries
   in the order of ``indices``;
2. it serialises every request body, opens a few keep-alive
   connections with one untimed request each, and writes ``ready``;
3. stdin: ``go <t_start> <t0> <t_end>`` (``time.monotonic`` seconds, a
   clock every process on the host shares). Each arrival is sent at
   ``t_start + due`` whether or not earlier requests have answered,
   while fewer than ``max_in_flight`` are in flight; one due while that
   many are is not sent and fails (status -3, done at once). Requests
   done from ``t0`` are recorded:
   pool index, due time (in the place of a send time, so a late send
   counts in the latency), done time, status, reply;
4. stdout: one JSON line: each recorded request with the ids and
   similarities its reply carried (parsed once the window is over), the
   process's CPU busy share over [t0, t_end], and how late it sent the
   window's arrivals (``late_ms``: median, p99, max).
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np

WARM = 8                # connections opened before the window


# an arrival due while the process has max_in_flight requests in flight
OVER_CAP = -3


async def open_loop(send, arrivals, t0: float, cap: int | None = None):
    """Start ``send(qidx)`` (a coroutine giving (status, payload)) for
    each (t_due, qidx) of ``arrivals`` (due times rising, on
    ``time.monotonic``) when it is due, whatever the earlier sends are
    doing; with ``cap``, an arrival due while ``cap`` sends are in
    flight is not sent and fails (``OVER_CAP``). Returns (records [qidx,
    t_due, t_done, status, payload] of the requests done from t0, the
    seconds each arrival due from t0 was started after its due time)."""
    records: list = []
    late: list[float] = []
    tasks: set = set()

    async def one(qidx, t_due):
        try:
            status, payload = await send(qidx)
        except Exception:  # noqa: BLE001 — a lost request fails
            status, payload = -1, b""
        t_done = time.monotonic()
        if t_done >= t0:
            records.append([qidx, t_due, t_done, status, payload])

    for t_due, qidx in arrivals:
        wait = t_due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        if cap is not None and len(tasks) >= cap:
            t_now = time.monotonic()
            if t_now >= t0:
                records.append([qidx, t_due, t_now, OVER_CAP, b""])
            continue
        if t_due >= t0:
            late.append(time.monotonic() - t_due)
        task = asyncio.ensure_future(one(qidx, t_due))
        tasks.add(task)
        task.add_done_callback(tasks.discard)
    while tasks:
        await asyncio.gather(*list(tasks))
    return records, late


async def _serve(hdr: dict, bodies: dict[int, bytes], go_line, out: dict):
    import aiohttp
    url = hdr["url"] + "/vectors/query"
    headers = {"Authorization": f"Bearer {hdr['key']}",
               "Content-Type": "application/json"}
    timeout = aiohttp.ClientTimeout(total=float(hdr["timeout_s"]))
    cap = int(hdr["max_in_flight"])
    connector = aiohttp.TCPConnector(limit=cap, force_close=False)
    async with aiohttp.ClientSession(connector=connector,
                                     timeout=timeout) as session:

        async def send(qidx):
            async with session.post(url, data=bodies[qidx],
                                    headers=headers) as r:
                return r.status, await r.read()

        warm = await asyncio.gather(*[send(hdr["indices"][0])
                                      for _ in range(min(WARM, cap))])
        if any(status != 200 for status, _ in warm):
            raise RuntimeError(f"warm-up request: HTTP "
                               f"{[status for status, _ in warm]}")
        loop = asyncio.get_running_loop()
        line = await loop.run_in_executor(None, go_line)
        _, t_start, t0, t_end = line.split()
        t_start, t0, t_end = float(t_start), float(t0), float(t_end)
        arrivals = [(t_start + d, q) for d, q in zip(hdr["due"],
                                                     hdr["queries"])]

        async def busy():
            await asyncio.sleep(max(0.0, t0 - time.monotonic()))
            c0 = time.process_time()
            await asyncio.sleep(max(0.0, t_end - time.monotonic()))
            out["busy_share"] = (time.process_time() - c0) / (t_end - t0)

        (records, late), _ = await asyncio.gather(
            open_loop(send, arrivals, t0, cap), busy())
        out["records"] = records
        out["late_ms"] = [1e3 * float(np.percentile(late, p)) if late
                          else 0.0 for p in (50, 99, 100)]


def main() -> int:
    inp, outp = sys.stdin.buffer, sys.stdout.buffer
    hdr = json.loads(inp.readline())
    idx = hdr["indices"]
    raw = inp.read(len(idx) * hdr["dim"] * 4)
    qs = np.frombuffer(raw, np.float32).reshape(len(idx), hdr["dim"])
    bodies = {int(i): json.dumps({
        "user_id": hdr["user_id"], "model_id": hdr["model_id"],
        "query": q.tolist(), "k": hdr["k"]}).encode()
        for i, q in zip(idx, qs)}

    def ready_then_go() -> str:
        outp.write(b"ready\n")
        outp.flush()
        return inp.readline().decode()

    out: dict = {}
    asyncio.run(_serve(hdr, bodies, ready_then_go, out))
    rows = []
    for qidx, t_due, t_done, status, payload in out["records"]:
        ids, sims = [], []
        if status == 200:
            try:
                for r in json.loads(payload)["results"]:
                    ids.append(int(r["index"]))
                    sims.append(float(r["similarity"]))
            except (ValueError, KeyError, TypeError):
                status = -2
        rows.append([qidx, t_due, t_done, status, ids, sims])
    outp.write(json.dumps({"records": rows,
                           "busy_share": out.get("busy_share", 0.0),
                           "late_ms": out["late_ms"]}).encode() + b"\n")
    outp.flush()
    return 0


if __name__ == "__main__":
    # run as a script: its folder must not shadow a module aiohttp imports
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]
    sys.exit(main())
