"""Open-loop REST arrivals: a Poisson process at ``rate`` queries a
second, drawn from the run's seed, each arrival one ``POST
/vectors/query`` of the next pool vector at ``k`` (no filter), sent
when it is due whether or not earlier requests have answered. The
arrivals are dealt in turn to ``client_processes`` processes of
``rest_open_loop_client.py`` (no torch), whose bodies are serialised
before the window; each process keeps at most its even share of
``max_in_flight`` requests in flight, and an arrival past that is not
sent and counts as failed. ``lead_s`` seconds of the same traffic run
before the window opens; a request not answered within ``timeout_s``
fails.

A request is timed from its scheduled arrival to its reply's last byte,
so a sender that runs late shows as latency (no coordinated omission);
the clients log how late they sent. Arrivals are counted in the window
by their scheduled time.

``rest_closed.drive`` serves the app and reads its counters, with these
client processes in place of ``client.py``'s closed-loop users, so the
traced run's record (``Window.trace``: ``http``, ``coalescer``) is the
one ``rest_closed`` gives.

A traffic file of this generator holds ``"generator":
"rest_open_loop"`` and exactly the keys of ``KEYS``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

from benchmark_h100 import datagen, loadgen, window

HERE = Path(__file__).resolve().parent
CLIENT = HERE / "rest_open_loop_client.py"

REST = True
KEYS = {"rate": float, "client_processes": int, "max_in_flight": int,
        "k": int, "lead_s": float, "timeout_s": float}


def _rest_closed():
    """A private copy of ``rest_closed``, whose ``loadgen`` the caller
    may replace."""
    spec = importlib.util.spec_from_file_location(
        "bench_traffic_rest_open_loop_base", HERE / "rest_closed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


warm_shapes = _rest_closed().warm_shapes


def arrivals(seed: int, rate: float, span_s: float) -> np.ndarray:
    """Arrival times (s from the traffic's start) of a Poisson process
    at ``rate`` a second over [0, span_s), from the run's seed."""
    rng = np.random.default_rng(datagen.derive_seed(seed, "arrivals"))
    gaps: list[np.ndarray] = []
    total = 0.0
    while total < span_s:
        g = rng.exponential(1.0 / rate, int(rate * span_s) + 64)
        gaps.append(g)
        total += float(g.sum())
    t = np.cumsum(np.concatenate(gaps))
    return t[t < span_s]


class OpenLoad(loadgen.RestLoad):
    """The client processes of one run: arrival i of ``arrivals`` goes
    to process i mod P and asks pool query i mod the pool's size."""

    def __init__(self, url: str, key: str, tenant: tuple[str, str],
                 pool: np.ndarray, traffic: dict, seed: int,
                 span_s: float) -> None:
        t = arrivals(seed, float(traffic["rate"]), span_s)
        n_proc = max(1, int(traffic["client_processes"]))
        cap = max(1, int(traffic["max_in_flight"]) // n_proc)
        self.procs = []
        for p in range(n_proc):
            mine = np.arange(p, len(t), n_proc)
            qidx = mine % len(pool)
            uniq = np.unique(qidx)
            hdr = {"url": url, "key": key, "user_id": tenant[0],
                   "model_id": tenant[1], "k": int(traffic["k"]),
                   "indices": uniq.tolist(), "dim": int(pool.shape[1]),
                   "timeout_s": float(traffic["timeout_s"]),
                   "max_in_flight": cap, "due": t[mine].tolist(),
                   "queries": qidx.tolist()}
            proc = subprocess.Popen([sys.executable, str(CLIENT)],
                                    stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE)
            proc.stdin.write(json.dumps(hdr).encode() + b"\n")
            proc.stdin.write(np.ascontiguousarray(pool[uniq],
                                                  np.float32).tobytes())
            proc.stdin.flush()
            self.procs.append(proc)

    def collect(self, timeout_s: float) -> tuple[list, list[float]]:
        """As ``RestLoad.collect``, and each process's lateness logged:
        how far after its due time it sent a request of the window."""
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
            window.log("open-loop client: sent late by (ms) "
                       + json.dumps(got["late_ms"]))
        return records, busy


def drive(*, seed: int, seconds: float, traffic: dict, **kw):
    # arrivals from the traffic's start to the window's end
    span_s = float(traffic["lead_s"]) + seconds
    base = _rest_closed()
    base.loadgen = types.SimpleNamespace(
        RestLoad=lambda url, key, tenant, pool, traffic: OpenLoad(
            url, key, tenant, pool, traffic, seed, span_s))
    return base.drive(seed=seed, seconds=seconds, traffic=traffic, **kw)
