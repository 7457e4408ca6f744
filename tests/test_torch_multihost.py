"""Multi-host serving of the port (``tpu_vector_db_torch``), on the CPU
with gloo: tests/test_multihost.py's cases, and more, run on two real
processes that join one ``torch.distributed`` group.

* The sharded flat scan over a 2 x 2 mesh (two processes, two CPU shards
  each) equals the port's single-process scan over 4 shards, ids and keys
  exactly, and JAX's ``flat_scan_topk`` on the same rows (ids exactly,
  keys within 1e-6), with a filter and a deleted row, at k 5 and 100,
  also when one process's shards hold no live row.
* Sharded IVF and beam-graph stores across the processes answer as the
  single-process 4-shard stores do; a process's index sidecar records its
  layout and is rebuilt by a store of another layout.
* Two REST servers in lockstep answer alike; a store the JAX package
  wrote is served by both as JAX serves it.
* A killed peer turns into a bounded 503 and a latched ``peer_lost``
  (``/health`` 503), and a restart of the group serves again; a stalled
  peer trips the collective watchdog.

The workers (``_torch_multihost_worker.py``,
``_torch_multihost_server_worker.py``) import no JAX; the references are
computed here and handed over in an npz.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vector_db.ops.scan import flat_scan_topk
from tpu_vector_db_torch.parallel import ShardedVectorStore
from tpu_vector_db_torch.parallel import mesh as pmesh
from tpu_vector_db_torch.parallel.sharded_scan import make_sharded_query_fn
from tpu_vector_db_torch.store.config import VectorStoreConfig

TESTS = Path(__file__).parent
REPO = TESTS.parent
WORKER = TESTS / "_torch_multihost_worker.py"
SERVER_WORKER = TESTS / "_torch_multihost_server_worker.py"
API_KEY, ADMIN_KEY = "mh-test-key", "mh-admin-key"
PROC_TIMEOUT = 240          # generous: test workers may share the host
UP_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "VDB_FORCE_CPU", "VECTOR_DB_SHARDED")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["VECTOR_DB_API_KEY"] = API_KEY
    env["VECTOR_DB_ADMIN_KEY"] = ADMIN_KEY
    env.update(extra)
    return env


def run_workers(mode: str, tmp_path: Path, data: dict | None = None
                ) -> list[dict]:
    """Both processes of ``mode``; each one's answers (OUT.npz)."""
    coordinator = f"127.0.0.1:{_free_port()}"
    src = tmp_path / "in.npz"
    np.savez(src, **(data or {}))
    outs = [tmp_path / f"out{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, coordinator, str(r), str(src),
         str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(), cwd=tmp_path) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"multihost workers timed out; output so far: {logs}")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log[-3000:]}"
        assert f"MULTIHOST_OK process={r} jax_loaded=False" in log, log
        if mode == "mismatch":
            assert f"MISMATCH_RAISES process={r}" in log, log
    return [dict(np.load(o)) for o in outs] if mode != "mismatch" else []


# ------------------------------------------------------------ unit cases

def test_bootstrap_is_a_noop_at_one_process():
    assert not pmesh.bootstrap_distributed("127.0.0.1:1", 1, 0)
    assert not pmesh.bootstrap_distributed()
    assert (pmesh.process_index(), pmesh.process_count()) == (0, 1)
    m = pmesh.make_device_mesh(devices=["cpu"] * 2)
    assert (m.n_shards, m.first_shard, m.multiprocess) == (2, 0, False)


def test_bootstrap_raises_on_unreachable_coordinator():
    """No single-host fallback: a group that cannot form raises, within
    its timeout (the TCP store's connect retries take about 2x)."""
    import torch.distributed as dist
    t0 = time.time()
    with pytest.raises(Exception, match="(?i)time"):
        pmesh.bootstrap_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                                    timeout_s=2)
    assert time.time() - t0 < 30
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        pmesh.bootstrap_distributed(None, 2, 1)


def test_mesh_global_shard_ranges(tmp_path, rng):
    """Process 1 of 2 with 2 shards holds global shards 2 and 3: a store
    on it uploads only rows [cap/2, cap) and slices masks the same way;
    the rest stays in the host buffer."""
    mesh = pmesh.Mesh((torch.device("cpu"),) * 2, (4,), ("shard",), 1, 2)
    assert (mesh.size, mesh.n_shards, mesh.first_shard) == (2, 4, 2)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    store = ShardedVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=16, persist_mode="off", initial_capacity=1024,
        block_rows=64), mesh=mesh)
    store.add_vectors(x)
    rows = store._rows_per_shard
    assert (store._cap, rows, len(store._db)) == (1024, 256, 2)
    full = ShardedVectorStore(tmp_path / "f", VectorStoreConfig(
        dimension=16, persist_mode="off", initial_capacity=1024,
        block_rows=64), mesh=pmesh.make_device_mesh(devices=["cpu"] * 4))
    full.add_vectors(x)
    for s in range(2):
        assert torch.equal(store._db[s], full._db[2 + s])
    np.testing.assert_array_equal(store._host_buf[:1000], x)
    host_mask = np.arange(1024, dtype=np.float32)
    got = store._filter_mask(host_mask)
    assert [t[0].item() for t in got] == [512.0, 768.0]


def test_dispatch_latches_peer_lost(tmp_path, monkeypatch):
    """A gloo-like failure and a timeout each latch peer_lost and raise
    PeerLostError; a latched manager fails fast without running the call;
    other errors pass through unlatched."""
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.errors import PeerLostError
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    monkeypatch.setenv("VECTOR_DB_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("VECTOR_DB_COLLECTIVE_TIMEOUT_S", "0.5")
    ran = []

    def gloo_error():
        raise RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection "
                           "closed by peer [127.0.0.1]:1951")

    def slow():
        time.sleep(2.0)

    def mine(exc):
        def fn():
            ran.append(1)
            raise exc
        return fn

    async def go(mgr, fn):
        return await mgr._dispatch(fn)

    for fail in (gloo_error, slow):
        mgr = VectorStoreManager(base_path=tmp_path, device="cpu",
                                 errors=ErrorHandler(tmp_path / "logs"))
        with pytest.raises(ValueError):
            asyncio.run(go(mgr, mine(ValueError("bad k"))))
        assert not mgr.peer_lost and ran == [1]
        t0 = time.time()
        with pytest.raises(PeerLostError, match="peer"):
            asyncio.run(go(mgr, fail))
        assert mgr.peer_lost and time.time() - t0 < 1.9
        t0 = time.time()
        with pytest.raises(PeerLostError, match="restart"):
            asyncio.run(go(mgr, mine(ValueError("never runs"))))
        assert ran == [1] and time.time() - t0 < 0.5
        ran.clear()
        mgr.shutdown()


def test_peer_lost_is_a_503(tmp_path, monkeypatch):
    """A latched app answers every device route and /health with 503 and
    "peer_lost", without touching the worker pool."""
    from aiohttp.test_utils import TestClient, TestServer

    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    monkeypatch.setenv("VECTOR_DB_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("VDB_COALESCE_MS", "off")
    mgr = VectorStoreManager(base_path=tmp_path, device="cpu",
                             errors=ErrorHandler(tmp_path / "logs"))
    mgr.create_store("u", "m", VectorStoreConfig(dimension=4))
    mgr.peer_lost = True
    monkeypatch.delenv("VECTOR_DB_COORDINATOR")   # no group at startup

    async def go():
        async with TestClient(TestServer(create_app(manager=mgr))) as c:
            auth = {"Authorization": "Bearer "
                    + os.environ["VECTOR_DB_API_KEY"]}
            r = await c.post("/vectors/query", headers=auth, json={
                "user_id": "u", "model_id": "m", "query": [1, 0, 0, 0],
                "k": 1})
            body = await r.json()
            assert r.status == 503 and body["degraded"] == "peer_lost"
            assert "peer" in body["error"]
            r = await c.get("/health")
            assert r.status == 503 and (await r.json())["peer_lost"]
    asyncio.run(go())


def test_local_shard_count_mismatch_raises(tmp_path):
    """Processes that bring different shard counts cannot form a mesh:
    the all-gather at its making raises on every process."""
    run_workers("mismatch", tmp_path)


# ------------------------------------------------ two processes, library

def test_two_process_mesh(tmp_path):
    """tests/test_multihost.py::test_two_process_mesh on the port: a gloo
    all-gather sums to 1+1+2+2, and the sharded scan over 256 x 16 rows
    split across both processes (2 CPU shards each) equals the
    single-process P = 4 scan exactly and JAX's flat_scan_topk (ids
    exactly, keys within 1e-6), with a filter mask and a deleted row."""
    n, d, d_pad = 256, 16, 128
    rng = np.random.default_rng(0)
    raw = np.zeros((n, d_pad), np.float32)
    raw[:, :d] = rng.standard_normal((n, d))
    db = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    q = np.zeros((3, d_pad), np.float32)
    q[:, :d] = rng.standard_normal((3, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = (np.arange(n) % 3 != 0).astype(np.float32)   # a filter
    mask[int(np.argmax(db[:, :d] @ q[0, :d]))] = 0.0    # a deleted row
    # (k, count): k 5 and 100 over every row; k 5 over 100 rows, where
    # process 1's shards hold no live row and send -inf keys
    cases = np.array([[5, n], [100, n], [5, 100]])
    outs = run_workers("mesh", tmp_path, {"db": db, "queries": q,
                                          "mask": mask, "cases": cases})
    single = pmesh.make_device_mesh(devices=["cpu"] * 4)
    parts = [torch.from_numpy(db[s * 64:(s + 1) * 64]) for s in range(4)]
    mparts = [torch.from_numpy(mask[s * 64:(s + 1) * 64]) for s in range(4)]
    for out in outs:
        assert out["all_gather_sum"] == 1.0 + 1.0 + 2.0 + 2.0
    for i, (k, count) in enumerate(cases):
        fn, _ = make_sharded_query_fn(single, int(k), with_filter=True)
        want_keys, want_ids = (t.numpy() for t in fn(
            torch.from_numpy(q), parts, int(count), mparts))
        jkeys, jids = flat_scan_topk(
            jnp.asarray(q), jnp.asarray(db), jnp.int32(count), int(k),
            metric="cosine", db_normalized=True,
            filter_mask=jnp.asarray(mask > 0), block_rows=n)
        live = np.isfinite(want_keys)
        assert live.sum() == 3 * min(int(k), int(mask[:count].sum()))
        for out in outs:
            np.testing.assert_array_equal(out[f"ids_{i}"], want_ids)
            np.testing.assert_array_equal(out[f"keys_{i}"].view(np.int32),
                                          want_keys.view(np.int32))
            np.testing.assert_array_equal(out[f"ids_{i}"][live],
                                          np.asarray(jids)[live])
            np.testing.assert_allclose(out[f"keys_{i}"][live],
                                       np.asarray(jkeys)[live], atol=1e-6,
                                       rtol=0)


def test_two_process_ann(tmp_path):
    """A sharded IVF (nprobe 8) and a sharded beam graph (ef 64) over 2 x 2
    shards across the processes, built and extended by two adds, answer
    as the single-process P = 4 stores on the same rows, ids and keys
    exactly (every shard's k-means seed is its global shard number). A
    process's sidecar records its layout: a single-process P = 4 store
    opening it rebuilds, and answers the same."""
    from tpu_vector_db_torch.index import native
    if not native.available():
        pytest.skip("the native graph builder needs g++")
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((20, 16)).astype(np.float32)
    rows = (centres[rng.integers(0, 20, 4000)]
            + 0.3 * rng.standard_normal((4000, 16))).astype(np.float32)
    qs = (centres[rng.integers(0, 20, 16)]
          + 0.3 * rng.standard_normal((16, 16))).astype(np.float32)
    outs = run_workers("ann", tmp_path, {"rows": rows, "queries": qs,
                                         "dir": str(tmp_path / "stores")})
    torch.set_num_threads(1)
    single = pmesh.make_device_mesh(devices=["cpu"] * 4)
    params = {"ivf": {"index_type": "ivf", "nprobe": 8},
              "beam_graph": {"index_type": "beam_graph", "ef_search": 64,
                             "M": 8, "ef_construction": 64}}
    for kind, p in params.items():
        cfg = VectorStoreConfig(dimension=16, persist_mode="off",
                                enable_ann=True, ann_params=p)
        store = ShardedVectorStore(tmp_path / f"single_{kind}", cfg,
                                   mesh=single)
        store.add_vectors(rows[:2000])
        store.add_vectors(rows[2000:])
        ids, keys = store._ann_search(store._prepare_queries(qs), 10)
        query_ids = np.array([r[0] for r in store.batch_query(qs, k=10)])
        for out in outs:
            np.testing.assert_array_equal(out[f"{kind}_ids"], ids)
            np.testing.assert_array_equal(out[f"{kind}_keys"], keys)
            np.testing.assert_array_equal(out[f"{kind}_query_ids"],
                                          query_ids)
        # rank 0's files: the whole store, its own shards' index
        path = tmp_path / "stores" / "rank0" / kind
        sidecar = next(path.glob("ann_sharded_*.npz"))
        with np.load(sidecar) as z:
            assert z["layout"].tolist() == [2, 0, 2]
            assert int(z["meta"][0]) == 4
        reopened = ShardedVectorStore(path, mesh=single)
        assert reopened._ann.build_time_s > 0      # rebuilt, not served
        np.testing.assert_array_equal(
            np.array([r[0] for r in reopened.batch_query(qs, k=10)]),
            query_ids)


# ---------------------------------------------- two processes, REST

def call(port: int, path: str, payload=None, admin: bool = False,
         timeout: float = 120, method: str | None = None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json",
                 "Authorization": "Bearer " + (ADMIN_KEY if admin
                                               else API_KEY)})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def both(ports: list[int], path: str, payload=None, admin: bool = False):
    """Lockstep fan-out: every host must run the same collectives."""
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(call, p, path, payload, admin) for p in ports]
        return [f.result(timeout=PROC_TIMEOUT) for f in futs]


class Pair:
    """Two port servers of one serving group, on their own data dirs."""

    def __init__(self, dirs: list[Path], **env) -> None:
        coord = f"127.0.0.1:{_free_port()}"
        self.ports = [_free_port(), _free_port()]
        self.procs = []
        for r in range(2):
            dirs[r].mkdir(parents=True, exist_ok=True)
            self.procs.append(subprocess.Popen(
                [sys.executable, str(SERVER_WORKER), coord, str(r),
                 str(self.ports[r])], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=dirs[r],
                env=_env(VECTOR_DB_DATA_DIR=str(dirs[r]), **env)))
        deadline = time.time() + UP_TIMEOUT
        up = [False, False]
        while time.time() < deadline and not all(up):
            for r, port in enumerate(self.ports):
                if up[r]:
                    continue
                if self.procs[r].poll() is not None:
                    self.close()
                    pytest.fail(f"server {r} died early:\n"
                                f"{self.logs[r][-3000:]}")
                try:
                    call(port, "/health", timeout=5)
                    up[r] = True
                except (urllib.error.URLError, OSError):
                    time.sleep(0.5)
        if not all(up):
            self.close()
            pytest.fail(f"servers did not come up: {self.logs}")

    def close(self, sig=signal.SIGTERM) -> list[str]:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(sig)
        self.logs = []
        for p in self.procs:
            try:
                self.logs.append(p.communicate(timeout=30)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                self.logs.append(p.communicate()[0])
        return self.logs


def test_two_process_server_rest(tmp_path):
    """tests/test_multihost.py::test_two_process_server_rest on the port:
    two servers bootstrap at startup and serve a sharded store through
    REST in lockstep. Both answer alike, as one CPU store does; top-1 is
    the query row; a batch_query at k 100 too. Both exit cleanly on
    SIGTERM without having imported JAX."""
    from tpu_vector_db_torch import TorchVectorStore
    rng = np.random.default_rng(3)
    d, n = 16, 300
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    plain = TorchVectorStore(tmp_path / "plain", VectorStoreConfig(
        dimension=d, persist_mode="off"), device="cpu")
    plain.add_vectors(vecs)
    pair = Pair([tmp_path / "proc0", tmp_path / "proc1"])
    who = {"user_id": "mh", "model_id": "m"}
    try:
        both(pair.ports, "/admin/create_store",
             {**who, "dimension": d, "index_type": "flat"}, admin=True)
        res = both(pair.ports, "/vectors/add", {
            **who, "vectors": vecs.tolist(),
            "metadata": [{"i": i} for i in range(n)]})
        assert all(r["total"] == n for r in res), res
        q = both(pair.ports, "/vectors/query",
                 {**who, "query": vecs[42].tolist(), "k": 3})
        ids = [[item["index"] for item in r["results"]] for r in q]
        assert q[0]["store_count"] == q[1]["store_count"] == n
        assert ids[0] == ids[1] and ids[0][0] == 42, ids
        b = both(pair.ports, "/vectors/batch_query",
                 {**who, "queries": vecs[:8].tolist(), "k": 100})
        assert b[0]["results"] == b[1]["results"]
        for got, want in zip(b[0]["results"], plain.batch_query(vecs[:8],
                                                                k=100)):
            assert [r["index"] for r in got] == want[0]
            np.testing.assert_allclose([r["similarity"] for r in got],
                                       want[1], atol=1e-6, rtol=0)
    finally:
        logs = pair.close()
    for r, log in enumerate(logs):
        assert f"SERVER_EXIT_OK process={r} jax_loaded=False" in log, \
            log[-3000:]


def test_two_process_server_rest_ann(tmp_path):
    """An ``ivf`` tenant (nprobe 8) and a ``beam_graph`` tenant (ef 64),
    made by /admin/create_store and filled by two /vectors/add calls in
    lockstep, served by the two servers (one CPU shard each): both answer
    /vectors/batch_query alike, and as the single-process sharded store
    (P = 2, the same config and adds) answers the same queries."""
    from tpu_vector_db_torch.index import native
    rng = np.random.default_rng(5)
    d = 16
    centres = rng.standard_normal((20, d)).astype(np.float32)
    rows = (centres[rng.integers(0, 20, 4000)]
            + 0.3 * rng.standard_normal((4000, d))).astype(np.float32)
    qs = (centres[rng.integers(0, 20, 16)]
          + 0.3 * rng.standard_normal((16, d))).astype(np.float32)
    kinds = {"ivf": {"index_type": "ivf", "nprobe": 8}}
    if native.available():      # the sharded graph's native builder
        kinds["beam_graph"] = {"index_type": "beam_graph", "ef_search": 64,
                               "M": 8, "ef_construction": 64}
    torch.set_num_threads(1)
    single = pmesh.make_device_mesh(devices=["cpu"] * 2)
    pair = Pair([tmp_path / "proc0", tmp_path / "proc1"])
    try:
        for kind, params in kinds.items():
            who = {"user_id": "mh", "model_id": kind}
            both(pair.ports, "/admin/create_store",
                 {**who, "dimension": d, "index_type": kind,
                  "ann_params": params}, admin=True)
            ref = ShardedVectorStore(tmp_path / f"single_{kind}",
                                     VectorStoreConfig(
                                         dimension=d, enable_ann=True,
                                         persist_mode="off",
                                         ann_params=params), mesh=single)
            for part in (rows[:2000], rows[2000:]):
                res = both(pair.ports, "/vectors/add",
                           {**who, "vectors": part.tolist()})
                ref.add_vectors(part)
                assert all(r["total"] == len(ref) for r in res), res
            got = both(pair.ports, "/vectors/batch_query",
                       {**who, "queries": qs.tolist(), "k": 10})
            assert got[0]["results"] == got[1]["results"], kind
            want = ref.batch_query(qs, k=10)
            ann_ids, _ = ref._ann_search(ref._prepare_queries(qs), 10)
            for g, w, a in zip(got[0]["results"], want, ann_ids):
                assert [r["index"] for r in g] == w[0] == a.tolist(), kind
                np.testing.assert_allclose([r["similarity"] for r in g],
                                           w[1], atol=1e-6, rtol=0)
    finally:
        pair.close()


def test_jax_written_store_served_by_two_processes(tmp_path):
    """A store written by the JAX package's TPUVectorStore (with a deleted
    row) is opened by both port servers from their own data dirs (the
    files hard-linked) and served as JAX serves it."""
    from tpu_vector_db import VectorStoreConfig as JaxConfig
    from tpu_vector_db import TPUVectorStore
    rng = np.random.default_rng(11)
    d, n = 16, 500
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((8, d)).astype(np.float32)
    src = tmp_path / "jax" / "mh" / "m"
    jstore = TPUVectorStore(src, JaxConfig(dimension=d,
                                           persist_mode="lazy"))
    jstore.add_vectors(vecs, [{"i": i} for i in range(n)])
    jstore.delete_vectors([7])
    jstore.flush()
    want = jstore.batch_query(qs, k=10)
    dirs = [tmp_path / f"proc{r}" for r in range(2)]
    for base in dirs:
        (base / "mh" / "m").mkdir(parents=True)
        for f in src.iterdir():
            if f.is_file():
                os.link(f, base / "mh" / "m" / f.name)
    pair = Pair(dirs)
    try:
        counts = both(pair.ports, "/vectors/count?user_id=mh&model_id=m")
        assert [c["count"] for c in counts] == [n - 1, n - 1]
        got = both(pair.ports, "/vectors/batch_query", {
            "user_id": "mh", "model_id": "m", "queries": qs.tolist(),
            "k": 10})
        assert got[0]["results"] == got[1]["results"]
        for g, (w_ids, w_scores, w_meta) in zip(got[0]["results"], want):
            assert [r["index"] for r in g] == w_ids
            assert [r["metadata"] for r in g] == w_meta
            np.testing.assert_allclose([r["similarity"] for r in g],
                                       np.round(w_scores, 6), atol=1.5e-6,
                                       rtol=0)
    finally:
        pair.close()


def test_worker_death_degrades_cleanly(tmp_path):
    """tests/test_multihost.py::test_worker_death_degrades_cleanly on the
    port: after SIGKILL of one server the survivor answers a bounded 503
    naming the peer, latches (the next query fast-fails, /health 503
    peer_lost), and a restart of the group on the same dirs serves the
    whole store again."""
    rng = np.random.default_rng(7)
    d, n = 16, 200
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    who = {"user_id": "mh", "model_id": "m"}
    query = {**who, "query": vecs[5].tolist(), "k": 3}
    dirs = [tmp_path / "proc0", tmp_path / "proc1"]
    env = {"VECTOR_DB_COLLECTIVE_TIMEOUT_S": "30"}
    pair = Pair(dirs, **env)
    try:
        both(pair.ports, "/admin/create_store",
             {**who, "dimension": d, "index_type": "flat"}, admin=True)
        both(pair.ports, "/vectors/add", {
            **who, "vectors": vecs.tolist(),
            "metadata": [{"i": i} for i in range(n)]})
        q = both(pair.ports, "/vectors/query", query)
        assert q[0]["results"][0]["index"] == 5
        pair.procs[1].send_signal(signal.SIGKILL)
        pair.procs[1].wait(timeout=30)

        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as err:
            call(pair.ports[0], "/vectors/query", query, timeout=60)
        assert err.value.code == 503
        assert time.time() - t0 < 45, "503 took too long (hang?)"
        body = json.loads(err.value.read().decode())
        assert "peer" in body["error"].lower() and \
            body["degraded"] == "peer_lost", body

        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as err:
            call(pair.ports[0], "/vectors/query", query, timeout=30)
        assert err.value.code == 503
        assert time.time() - t0 < 10, "degraded query should fast-fail"

        with pytest.raises(urllib.error.HTTPError) as err:
            call(pair.ports[0], "/health", timeout=10)
        assert err.value.code == 503
        assert json.loads(err.value.read().decode())["peer_lost"]
    finally:
        pair.close(signal.SIGKILL)

    pair = Pair(dirs, **env)     # the same dirs: the stores reload
    try:
        q = both(pair.ports, "/vectors/query", query)
        assert q[0]["results"] == q[1]["results"]
        assert q[0]["results"][0]["index"] == 5, "recovery serve failed"
        assert q[0]["store_count"] == n
    finally:
        pair.close()


def test_stalled_peer_trips_watchdog(tmp_path):
    """A SIGSTOPped peer does not close its connection: the survivor's
    collective waits, as NCCL's would, and the watchdog
    (VECTOR_DB_COLLECTIVE_TIMEOUT_S=5) answers 503 within timeout + 20 s
    and latches."""
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    who = {"user_id": "mh", "model_id": "m"}
    query = {**who, "query": vecs[3].tolist(), "k": 3}
    pair = Pair([tmp_path / "proc0", tmp_path / "proc1"],
                VECTOR_DB_COLLECTIVE_TIMEOUT_S="5")
    try:
        both(pair.ports, "/admin/create_store",
             {**who, "dimension": 16, "index_type": "flat"}, admin=True)
        both(pair.ports, "/vectors/add", {**who, "vectors": vecs.tolist()})
        assert both(pair.ports, "/vectors/query",
                    query)[0]["results"][0]["index"] == 3
        pair.procs[1].send_signal(signal.SIGSTOP)
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as err:
            call(pair.ports[0], "/vectors/query", query, timeout=60)
        assert err.value.code == 503
        assert time.time() - t0 < 5 + 20
        assert json.loads(err.value.read().decode())["degraded"] == \
            "peer_lost"
        with pytest.raises(urllib.error.HTTPError) as err:
            call(pair.ports[0], "/health", timeout=10)
        assert err.value.code == 503
    finally:
        pair.close(signal.SIGKILL)
