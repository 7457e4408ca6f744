"""The serving layer as a whole: the JAX package's server and the torch
port's answer one REST sequence alike.

Each app runs in process on the CPU (the JAX package on its CPU backend,
the port with ``device="cpu"``) over 2,000 x 64 f32 rows made from a
seed. The sequence: create, add with metadata, query, batch query at
k 10 and 40, a filtered query, delete, get by id, count, stats, an
``index_type="ivf"`` store probed in full, the 401/403/404/409/413/422
cases, and 16 concurrent queries folded by the coalescer. Both must give
the same status codes, ids equal away from near-ties and similarities
within 1e-5 (f32, sums in another order; the server rounds to 6 digits).

Also: the port's server lists and answers the stores the JAX server
wrote (the on-disk format is shared), and the JAX package's SDK, as it
is, runs the cases of tests/test_sdk.py against the port's server.
"""

import asyncio
import inspect

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import test_sdk  # tests/test_sdk.py: its cases, run against the port

AUTH = {"Authorization": f"Bearer {test_sdk.API_KEY}"}
ADMIN = {"Authorization": f"Bearer {test_sdk.ADMIN_KEY}"}
SIM_TOL = 1e-5
N, D = 2000, 64
USER = "par"
IVF_PARAMS = {"min_rows": 0, "n_clusters": 16, "nprobe": 16,
              "self_check": False}


def jax_app(base):
    from tpu_vector_db.api.app import create_app
    from tpu_vector_db.service.batcher import QueryCoalescer
    from tpu_vector_db.service.manager import VectorStoreManager
    app = create_app(manager=VectorStoreManager(base_path=base))
    app["coalescer"] = QueryCoalescer(app["manager"], window_ms=20,
                                      max_batch=64)
    return app


def port_app(base, tmp_path):
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.batcher import QueryCoalescer
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    app = create_app(manager=VectorStoreManager(
        base_path=base, device="cpu", errors=ErrorHandler(tmp_path / "logs")))
    app["coalescer"] = QueryCoalescer(app["manager"], window_ms=20,
                                      max_batch=64)
    return app


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(1234)
    rows = g.standard_normal((N, D)).astype(np.float32)
    qs = rows[:16] + 0.1 * g.standard_normal((16, D)).astype(np.float32)
    meta = [{"i": i, "cat": i % 4} for i in range(N)]
    return rows, qs, meta


async def sequence(client: TestClient, rows, qs, meta) -> dict:
    """The REST sequence; returns {step: (status, body)}."""
    out = {}

    async def step(name, method, path, **kw):
        r = await client.request(method, path, **kw)
        body = await (r.json() if r.content_type == "application/json"
                      else r.text())
        out[name] = (r.status, body)
        return body

    def who(model):
        return {"user_id": USER, "model_id": model}

    flat = who("flat")
    await step("401", "GET", "/vectors/count", params=flat)
    await step("403", "POST", "/admin/create_store", headers=AUTH,
               json={**flat, "dimension": D})
    await step("create", "POST", "/admin/create_store", headers=ADMIN,
               json={**flat, "dimension": D})
    await step("409", "POST", "/admin/create_store", headers=ADMIN,
               json={**flat, "dimension": D})
    await step("413", "POST", "/admin/create_store", headers=ADMIN,
               json={**who("big"), "dimension": 768,
                     "expected_rows": 50_000_000})
    for half in (0, 1):
        part = slice(half * N // 2, (half + 1) * N // 2)
        await step(f"add{half}", "POST", "/vectors/add", headers=AUTH,
                   json={**flat, "vectors": rows[part].tolist(),
                         "metadata": meta[part]})
    await step("422", "POST", "/vectors/query", headers=AUTH,
               json={**flat, "query": qs[0].tolist(), "k": 0})
    await step("404", "POST", "/vectors/query", headers=AUTH,
               json={**who("ghost"), "query": qs[0].tolist(), "k": 3})
    q0 = await step("query", "POST", "/vectors/query", headers=AUTH,
                    json={**flat, "query": qs[0].tolist(), "k": 10})
    for k in (10, 40):
        await step(f"batch{k}", "POST", "/vectors/batch_query", headers=AUTH,
                   json={**flat, "queries": qs.tolist(), "k": k})
    await step("filtered", "POST", "/vectors/query", headers=AUTH,
               json={**flat, "query": qs[1].tolist(), "k": 10,
                     "filter_metadata": {"cat": 1}})
    top = q0["results"][0]["index"]
    await step("delete", "POST", "/vectors/delete", headers=AUTH,
               json={**flat, "indices": [top]})
    await step("after_delete", "POST", "/vectors/query", headers=AUTH,
               json={**flat, "query": qs[0].tolist(), "k": 10})
    await step("get", "GET", "/vectors/get", headers=AUTH,
               params={**flat, "ids": "1,2,3"})
    await step("get_deleted", "GET", "/vectors/get", headers=AUTH,
               params={**flat, "ids": str(top)})
    await step("count", "GET", "/vectors/count", headers=AUTH, params=flat)
    await step("stats", "GET", "/vectors/stats", headers=AUTH, params=flat)

    ivf = who("ivf")
    await step("ivf_create", "POST", "/admin/create_store", headers=ADMIN,
               json={**ivf, "dimension": D, "index_type": "ivf",
                     "ann_params": IVF_PARAMS})
    await step("ivf_add", "POST", "/vectors/add", headers=AUTH,
               json={**ivf, "vectors": rows.tolist(), "metadata": meta})
    await step("ivf_batch", "POST", "/vectors/batch_query", headers=AUTH,
               json={**ivf, "queries": qs[:8].tolist(), "k": 10})
    await step("ivf_stats", "GET", "/vectors/stats", headers=AUTH,
               params=ivf)

    async def one(i):
        r = await client.post("/vectors/query", headers=AUTH,
                              json={**flat, "query": qs[i].tolist(),
                                    "k": 10})
        return r.status, (await r.json())["results"]

    got = await asyncio.gather(*[one(i) for i in range(16)])
    out["coalesced"] = ([s for s, _ in got], [r for _, r in got])
    await step("perf_stats", "GET", "/performance/stats", headers=AUTH)
    await step("direct", "POST", "/vectors/batch_query", headers=AUTH,
               json={**flat, "queries": qs.tolist(), "k": 10})
    await step("list", "GET", "/admin/list_stores", headers=ADMIN)
    return out


def assert_results_match(got: list[dict], want: list[dict]) -> None:
    """Similarities within SIM_TOL; ids equal where no other result's
    similarity lies within 2 * SIM_TOL (a near-tie may swap)."""
    assert len(got) == len(want)
    sims = np.array([r["similarity"] for r in want])
    np.testing.assert_allclose([r["similarity"] for r in got], sims,
                               atol=SIM_TOL)
    for pos, (g, w) in enumerate(zip(got, want)):
        if np.sum(np.abs(sims - sims[pos]) <= 2 * SIM_TOL) == 1:
            assert g["index"] == w["index"], pos
            assert g["metadata"] == w["metadata"]
        assert g["rank"] == w["rank"]


def run_jax(base, data):
    async def go():
        async with TestClient(TestServer(jax_app(base))) as client:
            return await sequence(client, *data)
    return asyncio.run(go())


def run_port(base, tmp_path, data):
    async def go():
        async with TestClient(TestServer(port_app(base, tmp_path))) as client:
            return await sequence(client, *data)
    return asyncio.run(go())


@pytest.fixture(scope="module")
def both(tmp_path_factory, data):
    """The sequence on both servers, each over its own base path, with a
    64 MiB device budget (the 413 case)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("VDB_HBM_BYTES", str(64 * 2**20))
    try:
        tmp = tmp_path_factory.mktemp("parity")
        jax_out = run_jax(tmp / "jax", data)
        port_out = run_port(tmp / "port", tmp, data)
    finally:
        mp.undo()
    return tmp, jax_out, port_out


def test_same_status_codes(both):
    _, jax_out, port_out = both
    assert sorted(jax_out) == sorted(port_out)
    want = {step: out[0] for step, out in jax_out.items()}
    got = {step: out[0] for step, out in port_out.items()}
    assert got == want
    for code in ("401", "403", "404", "409", "413", "422"):
        assert got[code] == int(code)
    assert set(got["coalesced"]) == {200}


@pytest.mark.parametrize("step", ["query", "filtered", "after_delete"])
def test_query_results(both, step):
    _, jax_out, port_out = both
    assert_results_match(port_out[step][1]["results"],
                         jax_out[step][1]["results"])
    if step == "filtered":
        assert all(r["metadata"]["cat"] == 1
                   for r in port_out[step][1]["results"])
    if step == "after_delete":
        deleted = jax_out["query"][1]["results"][0]["index"]
        assert deleted not in [r["index"]
                               for r in port_out[step][1]["results"]]


@pytest.mark.parametrize("step", ["batch10", "batch40", "ivf_batch"])
def test_batch_results(both, step):
    _, jax_out, port_out = both
    got, want = port_out[step][1]["results"], jax_out[step][1]["results"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_results_match(g, w)


def test_coalesced_results(both, data):
    """16 concurrent queries, folded into fewer flushes, answer as the
    JAX server's do, and as the port's own batch query of the same 16
    queries does."""
    _, jax_out, port_out = both
    assert port_out["perf_stats"][1]["coalescer"]["batches"] < 16
    for g, w in zip(port_out["coalesced"][1], jax_out["coalesced"][1]):
        assert_results_match(g, w)
    direct = port_out["direct"][1]["results"]
    for g, w in zip(port_out["coalesced"][1], direct):
        assert_results_match(g, w)


def test_mutations_and_reads(both):
    _, jax_out, port_out = both
    for step in ("add0", "add1", "ivf_add"):
        for key in ("added", "total"):
            assert port_out[step][1][key] == jax_out[step][1][key]
    assert port_out["delete"][1] == jax_out["delete"][1]
    assert port_out["count"][1]["count"] == N - 1
    assert port_out["count"][1] == jax_out["count"][1]
    g, w = port_out["get"][1], jax_out["get"][1]
    assert g["ids"] == w["ids"] and g["metadata"] == w["metadata"]
    np.testing.assert_array_equal(g["vectors"], w["vectors"])
    for step in ("stats", "ivf_stats"):
        assert port_out[step][1] == jax_out[step][1]
    assert port_out["ivf_stats"][1]["index_type"] == "ivf"
    names = [(s["user_id"], s["model_id"])
             for s in port_out["list"][1]["stores"]]
    assert names == [(s["user_id"], s["model_id"])
                     for s in jax_out["list"][1]["stores"]]


def test_port_serves_jax_written_stores(both, tmp_path, data):
    """A fresh port server over the JAX server's base path lists its
    stores and answers as the JAX server did, deletes included."""
    tmp, jax_out, _ = both
    _, qs, _ = data

    async def go():
        app = port_app(tmp / "jax", tmp_path)
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/admin/list_stores", headers=ADMIN)
            listed = {(s["user_id"], s["model_id"])
                      for s in (await r.json())["stores"]}
            assert listed == {(s["user_id"], s["model_id"])
                              for s in jax_out["list"][1]["stores"]}
            flat = {"user_id": USER, "model_id": "flat"}
            r = await client.get("/vectors/count", headers=AUTH, params=flat)
            assert (await r.json()) == jax_out["count"][1]
            r = await client.post("/vectors/query", headers=AUTH, json={
                **flat, "query": qs[0].tolist(), "k": 10})
            assert_results_match((await r.json())["results"],
                                 jax_out["after_delete"][1]["results"])
            r = await client.post("/vectors/batch_query", headers=AUTH, json={
                "user_id": USER, "model_id": "ivf",
                "queries": qs[:8].tolist(), "k": 10})
            for g, w in zip((await r.json())["results"],
                            jax_out["ivf_batch"][1]["results"]):
                assert_results_match(g, w)
    asyncio.run(go())


SDK_CASES = [name for name, fn in inspect.getmembers(test_sdk,
                                                     inspect.isfunction)
             if name.startswith("test_")]


@pytest.mark.parametrize("case", SDK_CASES)
def test_jax_sdk_against_port(case, tmp_path, rng):
    """tests/test_sdk.py's case, unchanged, with its server the port's."""
    def server_factory():
        return TestServer(port_app(tmp_path / "stores", tmp_path))

    fn = getattr(test_sdk, case)
    args = {"server_factory": server_factory, "rng": rng}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_same_routes(tmp_path):
    """The port's app has every route of the JAX app, and no other."""
    def routes(app):
        return sorted((r.method, r.resource.canonical)
                      for r in app.router.routes())

    jax, port = jax_app(tmp_path / "j"), port_app(tmp_path / "p", tmp_path)
    try:
        assert routes(port) == routes(jax)
    finally:
        jax["manager"].shutdown()
        port["manager"].shutdown()
