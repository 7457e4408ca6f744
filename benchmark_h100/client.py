"""A load-generating client process: closed-loop REST users, no torch.

Started by ``loadgen.RestLoad`` with pipes on stdin and stdout:

1. stdin: one JSON header line (url, key, tenant, k, this process's
   users and the pool indices it serves, dim, timeout), then the f32
   bytes of those pool queries in that order;
2. it serialises every request body, opens one keep-alive connection a
   user with one untimed request each, and writes ``ready``;
3. stdin: ``go <t_start> <t0> <t_end>`` (``time.monotonic`` seconds, a
   clock every process on the host shares). Each user sends from
   ``t_start``, one request at a time, the next when its reply has been
   read, and sends none from ``t_end``; requests done from ``t0`` are
   recorded: pool index, send and done times, status, reply bytes;
4. stdout: one JSON line: each recorded request with the ids and
   similarities its reply carried (parsed once the window is over), and
   the process's CPU busy share over [t0, t_end].

User g of U sends pool queries g, g + U, g + 2U, ... and starts again at
g when it runs out.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

# run as a script: its folder must not shadow a module aiohttp imports
_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]

import numpy as np  # noqa: E402


def user_sequence(g: int, n_users: int, pool: int) -> list[int]:
    return list(range(g, pool, n_users)) or [g % pool]


async def _serve(hdr: dict, bodies: dict[int, bytes], go_line, out: dict):
    import aiohttp
    users = hdr["users"]
    url = hdr["url"] + "/vectors/query"
    headers = {"Authorization": f"Bearer {hdr['key']}",
               "Content-Type": "application/json"}
    timeout = aiohttp.ClientTimeout(total=float(hdr["timeout_s"]))
    connector = aiohttp.TCPConnector(limit=len(users), force_close=False)
    async with aiohttp.ClientSession(connector=connector,
                                     timeout=timeout) as session:
        seqs = {g: user_sequence(g, hdr["n_users"], hdr["pool"])
                for g in users}

        async def warm(g):
            async with session.post(url, data=bodies[seqs[g][-1]],
                                    headers=headers) as r:
                await r.read()
                if r.status != 200:
                    raise RuntimeError(f"warm-up request: HTTP {r.status}")

        await asyncio.gather(*[warm(g) for g in users])
        loop = asyncio.get_running_loop()
        line = await loop.run_in_executor(None, go_line)
        _, t_start, t0, t_end = line.split()
        t_start, t0, t_end = float(t_start), float(t0), float(t_end)
        records: list = []

        async def user(g):
            seq, j = seqs[g], 0
            await asyncio.sleep(max(0.0, t_start - time.monotonic()))
            while True:
                t_send = time.monotonic()
                if t_send >= t_end:
                    return
                qidx = seq[j % len(seq)]
                j += 1
                try:
                    async with session.post(url, data=bodies[qidx],
                                            headers=headers) as r:
                        payload = await r.read()
                        status = r.status
                except Exception:  # noqa: BLE001 — a lost request fails
                    payload, status = b"", -1
                t_done = time.monotonic()
                if t_done >= t0:
                    records.append((qidx, t_send, t_done, status, payload))

        async def busy():
            await asyncio.sleep(max(0.0, t0 - time.monotonic()))
            c0 = time.process_time()
            await asyncio.sleep(max(0.0, t_end - time.monotonic()))
            out["busy_share"] = (time.process_time() - c0) / (t_end - t0)

        await asyncio.gather(busy(), *[user(g) for g in users])
        out["records"] = records


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
    for qidx, t_send, t_done, status, payload in out["records"]:
        ids, sims = [], []
        if status == 200:
            try:
                for r in json.loads(payload)["results"]:
                    ids.append(int(r["index"]))
                    sims.append(float(r["similarity"]))
            except (ValueError, KeyError, TypeError):
                status = -2
        rows.append([qidx, t_send, t_done, status, ids, sims])
    outp.write(json.dumps({"records": rows,
                           "busy_share": out.get("busy_share", 0.0)}
                          ).encode() + b"\n")
    outp.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
