"""The compiled decoder of query bodies (``api/query_body.py`` over
``csrc/query_body.cpp``), on the CPU.

Where it takes a body, its float32 vectors are bit-equal to the generic
path's ``np.asarray(<json.loads + pydantic value>, np.float32)``: the
benchmark client's own bodies, doubles of 1-17 significant digits across
float32's exponents, -0.0 and the integer -0, integers above 2**53,
float32 subnormals and decimals that round twice. Every body it leaves
(invalid UTF-8 or JSON, numbers outside strict JSON grammar or out of
range, NaN and Infinity, non-numbers in the vector, ragged or nested
rows, duplicate keys, ...) gets the same status, reason and answer
through the app as on the generic path alone. The counters, the
``api.decode`` span's ``route``, and an app without the library.
"""

import asyncio
import json
from decimal import Decimal

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.profiler import ProfilerActivity, profile

from tpu_vector_db_torch.api import query_body
from tpu_vector_db_torch.api.models import BatchQueryRequest, VectorQueryRequest
from tpu_vector_db_torch.monitoring import get_registry, tracing
from tpu_vector_db_torch.ops import _build

ADMIN_KEY = "tvdb_admin_test_key_0123456789"
# the admin key is accepted on every route and its rate tier is the highest
AUTH = {"Authorization": f"Bearer {ADMIN_KEY}",
        "Content-Type": "application/json"}
TENANT = {"user_id": "dec", "model_id": "m"}
DIM = 4
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def library():
    assert query_body.load(), "g++ builds csrc/query_body.cpp"


def generic(body: bytes, model_cls, field: str) -> np.ndarray:
    return np.asarray(getattr(model_cls.model_validate(json.loads(body)),
                              field), np.float32)


def assert_bit_equal(body: bytes, model_cls=VectorQueryRequest,
                     field: str = "query", rank: int = 1, taken=True):
    model = query_body.decode(body, model_cls, field, rank)
    if taken:
        assert model is not None, body[:200]
    want = generic(body, model_cls, field)
    if model is None:
        return
    got = getattr(model, field)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = model_cls.model_validate(json.loads(body))
    assert model.model_dump(exclude={field}) == ref.model_dump(
        exclude={field})


def query_body_of(tokens, **extra) -> bytes:
    return ('{"user_id": "u", "model_id": "m", "query": [%s], "k": 10%s}'
            % (", ".join(tokens), "".join(f', "{k}": {json.dumps(v)}'
                                          for k, v in extra.items()))
            ).encode()


# ------------------------------------------------------------ bit-equality

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_benchmark_clients_bodies(seed):
    """The body ``benchmark_h100/client.py`` sends: ``json.dumps`` of a
    float32 query's ``tolist()`` (17-digit reprs), and a batch of them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(768).astype(np.float32)
    body = json.dumps({"user_id": "bench-tenant", "model_id": "cohere768",
                       "query": q.tolist(), "k": 10}).encode()
    assert_bit_equal(body)
    model = query_body.decode(body, VectorQueryRequest, "query", 1)
    np.testing.assert_array_equal(model.query, q)
    qs = rng.standard_normal((64, 768)).astype(np.float32)
    body = json.dumps({"user_id": "bench-tenant", "model_id": "cohere768",
                       "queries": qs.tolist(), "k": 100}).encode()
    assert_bit_equal(body, BatchQueryRequest, "queries", 2)


@pytest.mark.parametrize("digits", range(1, 18))
def test_doubles_of_each_count_of_digits(digits):
    rng = np.random.default_rng(digits)
    mant = rng.uniform(1.0, 10.0, 512) * rng.choice([-1.0, 1.0], 512)
    exps = rng.integers(-46, 39, 512)
    vals = [m * 10.0 ** int(e) for m, e in zip(mant, exps)]
    toks = [f"{v:.{digits}g}" for v in vals]
    toks += [f"{v:.{digits - 1}e}" for v in vals[:64]]
    toks = [t for t in toks if abs(float(t)) <= FLT_MAX]
    toks += [t.upper() for t in toks[:32]]
    assert_bit_equal(query_body_of(toks))


def test_zeros_and_signs():
    toks = ["0", "-0", "0.0", "-0.0", "0e0", "-0e5", "-0E-3", "0.000",
            "-0.0e+2"]
    assert_bit_equal(query_body_of(toks))
    model = query_body.decode(query_body_of(["-0"]), VectorQueryRequest,
                              "query", 1)
    assert not np.signbit(model.query[0])          # float(int(-0)) is +0.0
    model = query_body.decode(query_body_of(["-0.0"]), VectorQueryRequest,
                              "query", 1)
    assert np.signbit(model.query[0])


def test_integers_above_two_to_the_53():
    ints = [2**53 + 1, 2**53 + 3, 2**63 - 1, 2**64 + 2**11 + 1,
            10**20 + 3, 12345678901234567890123, 2**100 + 1,
            -(2**90 + 7), 10**38, 340282346638528859811704183484516925440]
    assert_bit_equal(query_body_of([str(i) for i in ints]))


def test_float32_subnormals_and_tiny_doubles():
    bits = np.array([1, 2, 3, 0x7FFFFF, 0x400000, 0x12345, 0x800001],
                    np.uint32)
    subs = bits.view(np.float32).astype(np.float64)
    toks = [repr(float(v)) for v in subs] + [repr(-float(v)) for v in subs]
    half = 2.0 ** -150          # half the least subnormal: ties to 0
    toks += [repr(half), repr(half * 1.0000001), repr(half * 0.9999999),
             "1e-45", "1.4e-45", "7e-46", "1e-46", "1.1754942e-38",
             "1.17549435e-38", "4.9e-324", "1e-310",
             "2.2250738585072014e-308"]
    assert_bit_equal(query_body_of(toks))


def test_decimals_that_round_twice():
    """A decimal within a quarter of a double's ulp of the midpoint of two
    float32s rounds to that midpoint as a double and then to the even
    float32, where one rounding to float32 would go to the nearer one:
    both paths round twice."""
    rng = np.random.default_rng(7)
    lo = (rng.standard_normal(256) * 10.0 ** rng.integers(-30, 30, 256)
          ).astype(np.float32)
    hi = np.nextafter(lo, np.float32(np.inf))
    toks = []
    for a, b in zip(lo.astype(np.float64), hi.astype(np.float64)):
        mid = (a + b) / 2                       # exact in a double
        ulp = abs(np.spacing(mid))
        for off in (0.25, -0.25, 0.75, -0.75, 0.0):
            toks.append(str(Decimal(float(mid)) + Decimal(float(ulp))
                            * Decimal(off)))
    body = query_body_of(toks)
    assert_bit_equal(body)
    twice = query_body.decode(body, VectorQueryRequest, "query",
                              1).query.reshape(-1, 5)
    even = np.where(lo.view(np.uint32) % 2 == 0, lo, hi)
    for col in (0, 1, 4):           # +0.25, -0.25 and 0 ulp: the tie
        np.testing.assert_array_equal(twice[:, col], even)
    # one rounding to float32 would give hi above the midpoint and lo
    # below it: the cases are real
    assert (twice[:, 0] != hi).any() and (twice[:, 1] != lo).any()
    np.testing.assert_array_equal(twice[:, 2], hi)
    np.testing.assert_array_equal(twice[:, 3], lo)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(min_value=-FLT_MAX, max_value=FLT_MAX,
                          allow_nan=False), min_size=1, max_size=16),
       st.integers(1, 17))
def test_any_double_in_float32_range(values, digits):
    assert_bit_equal(query_body_of([repr(v) for v in values]))
    toks = [f"{v:.{digits}g}" for v in values]
    # rounded to fewer digits a value may pass FLT_MAX: the generic path's
    assert_bit_equal(query_body_of(toks),
                     taken=all(abs(float(t)) <= FLT_MAX for t in toks))


def test_a_body_of_the_densest_numbers():
    """One-digit numbers and no spaces: the output buffer's bound (a
    number and its comma take at least two bytes) holds."""
    body = b'{"query":[' + b",".join([b"7"] * 1000) + b'],"user_id":"u",' \
        b'"model_id":"m"}'
    assert_bit_equal(body)
    body = b'{"queries":[[1],[2],[3]],"user_id":"u","model_id":"m"}'
    assert_bit_equal(body, BatchQueryRequest, "queries", 2)


def test_the_rest_of_the_body_is_validated_as_before():
    body = (b'{"user_id": "d\\u0065c", "model_id": "m\\n", "k": 7, '
            b'"filter_metadata": {"a": [1, {"b": "]}\\""}], "c": null}, '
            b'"use_ann": false, "rerank": true, "extra": [[1], {}], '
            b'"query": [1, 2.5, -3e2, 4]}')
    assert_bit_equal(body)
    model = query_body.decode(body, VectorQueryRequest, "query", 1)
    assert model.user_id == "dec" and model.model_id == "m\n"
    assert model.filter_metadata == {"a": [1, {"b": ']}"'}], "c": None}
    assert (model.k, model.use_ann, model.rerank) == (7, False, True)


# ----------------------------------------------------- through the CPU app

def make_client(tmp_path) -> TestClient:
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    manager = VectorStoreManager(base_path=tmp_path / "stores", device="cpu",
                                 errors=ErrorHandler(tmp_path / "logs"))
    return TestClient(TestServer(create_app(manager=manager)))


async def fill(client) -> np.ndarray:
    rows = np.random.default_rng(5).standard_normal((32, DIM)).astype(
        np.float32)
    r = await client.post("/admin/create_store", headers=AUTH,
                          json={**TENANT, "dimension": DIM})
    assert r.status == 201, await r.text()
    r = await client.post("/vectors/add", headers=AUTH, json={
        **TENANT, "vectors": rows.tolist(),
        "metadata": [{"i": i, "even": i % 2 == 0} for i in range(32)]})
    assert r.status == 200, await r.text()
    return rows


def counts() -> tuple[float, float]:
    reg = get_registry()
    return (reg.counter("query_bodies_native_total").value,
            reg.counter("query_bodies_generic_total").value)


async def answer(client, path: str, body: bytes, headers=AUTH):
    """(status, the JSON reply less its clocks) of one POST."""
    r = await client.post(path, data=body, headers=headers)
    reply = await r.json()
    for key in ("timestamp", "query_time_ms", "qps"):
        reply.pop(key, None)
    return r.status, reply


def q(vec: str, **over) -> bytes:
    fields = {"user_id": '"dec"', "model_id": '"m"', "query": vec, "k": "3",
              **over}
    return ("{" + ", ".join(f'"{k}": {v}' for k, v in fields.items())
            + "}").encode()


def bq(rows: str, **over) -> bytes:
    fields = {"user_id": '"dec"', "model_id": '"m"', "queries": rows,
              "k": "2", **over}
    return ("{" + ", ".join(f'"{k}": {v}' for k, v in fields.items())
            + "}").encode()


V = "[0.5, -1, 2e-3, 7]"
# (name, path, body, headers or None, taken by the compiled path)
CASES = [
    ("plain", "/vectors/query", q(V), None, True),
    ("spaces", "/vectors/query",
     b'\n { "query" :\t[ 0.5 ,-1 , 2E-3,7 ] ,"k":3 , "model_id" : "m",'
     b'"user_id":"dec" }\r\n', None, True),
    ("escaped strings and a filter", "/vectors/query",
     q(V, user_id='"d\\u0065c"', filter_metadata='{"even": true}',
       use_ann="false", rerank="false", extra='[["]", {"}": null}]]'),
     None, True),
    ("the key escaped", "/vectors/query",
     b'{"user_id": "dec", "model_id": "m", "qu\\u0065ry": [1, 2, 3, 4]}',
     None, True),
    ("integers and -0", "/vectors/query", q("[-0, 3, 9007199254740993, 1]"),
     None, True),
    ("charset utf-8", "/vectors/query", q(V),
     {**AUTH, "Content-Type": "application/json; charset=UTF-8"}, True),
    ("wrong dimension", "/vectors/query", q("[1, 2, 3, 4, 5]"), None, True),
    ("no such store", "/vectors/query", q(V, model_id='"ghost"'), None,
     True),
    ("invalid UTF-8", "/vectors/query",
     q(V, user_id='"X"').replace(b"X", b"\xff"), None, False),
    ("not JSON", "/vectors/query", b"not json", None, False),
    ("empty body", "/vectors/query", b"", None, False),
    ("truncated", "/vectors/query", q(V)[:-5], None, False),
    ("trailing comma", "/vectors/query", q(V)[:-1] + b",}", None, False),
    ("missing comma", "/vectors/query", q(V).replace(b', "k"', b' "k"'),
     None, False),
    ("trailing data", "/vectors/query", q(V) + b" {}", None, False),
    ("a BOM", "/vectors/query", b"\xef\xbb\xbf" + q(V), None, False),
    ("top-level array", "/vectors/query", b"[" + q(V) + b"]", None, False),
    ("charset latin-1", "/vectors/query",
     q(V, user_id='"X"').replace(b"X", b"d\xe9c"),
     {**AUTH, "Content-Type": "application/json; charset=latin-1"}, False),
    ("leading zero", "/vectors/query", q("[01, 2, 3, 4]"), None, False),
    ("bare fraction", "/vectors/query", q("[.5, 2, 3, 4]"), None, False),
    ("dot without digits", "/vectors/query", q("[1., 2, 3, 4]"), None,
     False),
    ("dot before exponent", "/vectors/query", q("[1.e5, 2, 3, 4]"), None,
     False),
    ("plus sign", "/vectors/query", q("[+1, 2, 3, 4]"), None, False),
    ("hex", "/vectors/query", q("[0x10, 2, 3, 4]"), None, False),
    ("exponent without digits", "/vectors/query", q("[1e, 2, 3, 4]"), None,
     False),
    ("a lone minus", "/vectors/query", q("[-, 2, 3, 4]"), None, False),
    ("1e400", "/vectors/query", q("[1e400, 2, 3, 4]"), None, False),
    ("-1e400", "/vectors/query", q("[-1e400, 2, 3, 4]"), None, False),
    ("1e-400", "/vectors/query", q("[1e-400, 2, 3, 4]"), None, False),
    ("above float32", "/vectors/query", q("[1e39, 2, 3, 4]"), None, False),
    ("an integer above a double", "/vectors/query",
     q("[%d, 2, 3, 4]" % 10**400), None, False),
    ("NaN", "/vectors/query", q("[NaN, 2, 3, 4]"), None, False),
    ("Infinity", "/vectors/query", q("[Infinity, 2, 3, 4]"), None, False),
    ("-Infinity", "/vectors/query", q("[-Infinity, 2, 3, 4]"), None, False),
    ("a numeric string", "/vectors/query", q('["1.5", 2, 3, 4]'), None,
     False),
    ("a word", "/vectors/query", q('["one", 2, 3, 4]'), None, False),
    ("a boolean", "/vectors/query", q("[true, 2, 3, 4]"), None, False),
    ("null", "/vectors/query", q("[null, 2, 3, 4]"), None, False),
    ("nested rows", "/vectors/query", q("[[1, 2, 3, 4]]"), None, False),
    ("empty vector", "/vectors/query", q("[]"), None, False),
    ("not an array", "/vectors/query", q("4"), None, False),
    ("no vector", "/vectors/query", b'{"user_id": "dec", "model_id": "m"}',
     None, False),
    ("a duplicate key", "/vectors/query",
     q(V)[:-1] + b', "query": [4, 3, 2, 1]}', None, False),
    ("a duplicate escaped key", "/vectors/query",
     q(V)[:-1] + b', "quer\\u0079": [4, 3, 2, 1]}', None, False),
    ("deeply nested", "/vectors/query",
     q(V, extra="[" * 100000 + "]" * 100000), None, False),
    ("k zero", "/vectors/query", q(V, k="0"), None, False),
    ("k a word", "/vectors/query", q(V, k='"ten"'), None, False),
    ("a missing field", "/vectors/query", b'{"query": [1, 2, 3, 4]}', None,
     False),
    ("batch", "/vectors/batch_query", bq("[[1, 2, 3, 4], [0.5, -1, 0, 2]]"),
     None, True),
    ("batch of one", "/vectors/batch_query", bq("[ [1,2,3,4] ]"), None,
     True),
    ("batch ragged", "/vectors/batch_query", bq("[[1, 2, 3, 4], [1, 2]]"),
     None, False),
    ("batch empty", "/vectors/batch_query", bq("[]"), None, False),
    ("batch empty row", "/vectors/batch_query", bq("[[]]"), None, False),
    ("batch of rank 1", "/vectors/batch_query", bq("[1, 2, 3, 4]"), None,
     False),
    ("batch of rank 3", "/vectors/batch_query", bq("[[[1, 2, 3, 4]]]"),
     None, False),
    ("batch with a string", "/vectors/batch_query",
     bq('[[1, 2, 3, 4], [1, "2", 3, 4]]'), None, False),
    ("batch NaN", "/vectors/batch_query", bq("[[1, 2, 3, NaN]]"), None,
     False),
]


def test_every_body_answers_as_on_the_generic_path(tmp_path, monkeypatch):
    """Each body twice through one app, with the compiled path and then
    without it: the same status, reason and answer; the counters say
    which bodies the compiled path took."""
    async def go():
        async with make_client(tmp_path) as client:
            await fill(client)
            native, taken = [], []
            for _, path, body, headers, _ in CASES:
                before = counts()
                native.append(await answer(client, path, body,
                                           headers or AUTH))
                after = counts()
                taken.append((after[0] - before[0], after[1] - before[1]))
            monkeypatch.setattr(query_body.LIBRARY, "lib", None)
            plain = [await answer(client, path, body, headers or AUTH)
                     for _, path, body, headers, _ in CASES]
            return native, taken, plain
    native, taken, plain = asyncio.run(go())
    for (name, _, _, _, want), n, t, p in zip(CASES, native, taken, plain):
        assert n == p, name
        assert t == ((1, 0) if want else (0, 1)), name
    got = {name: n for (name, *_), n in zip(CASES, native)}
    # the cases reach what they are named for
    for name in ("plain", "spaces", "the key escaped", "batch",
                 "a numeric string", "a duplicate key"):
        assert got[name][0] == 200, name
    for name in ("invalid UTF-8", "a BOM", "leading zero", "plus sign",
                 "trailing data"):
        assert got[name] == (400, {"error": "invalid JSON body",
                                   "code": 400}), name
    for name in ("NaN", "1e400", "above float32", "batch NaN"):
        assert got[name] == (400, {"error": "vectors contain NaN or Inf",
                                   "code": 400}), name
    for name in ("k zero", "a word", "an integer above a double",
                 "batch empty", "top-level array"):
        assert got[name][0] == 422, name
    assert got["wrong dimension"][0] == got["batch ragged"][0] == 400


def test_the_decode_span_names_its_route(tmp_path):
    async def go():
        async with make_client(tmp_path) as client:
            await fill(client)
            tracing.reset()
            with profile(activities=[ProfilerActivity.CPU]):
                assert (await answer(client, "/vectors/query", q(V)))[0] \
                    == 200
                assert (await answer(client, "/vectors/query",
                                     q("[NaN, 2, 3, 4]")))[0] == 400
                assert (await answer(client, "/vectors/batch_query",
                                     bq("[[1, 2, 3, 4]]")))[0] == 200
    asyncio.run(go())
    decodes = [s for s in tracing.spans() if s["name"] == "api.decode"]
    tracing.reset()
    assert [s["attrs"].get("route") for s in decodes][-3:] == \
        ["native", "generic", "native"]


@pytest.mark.parametrize("how", ["a source g++ refuses", "no compiler"])
def test_without_the_library_the_app_serves_on_the_generic_path(
        tmp_path, monkeypatch, how):
    if how == "no compiler":
        empty = tmp_path / "bin"
        empty.mkdir()
        monkeypatch.setenv("PATH", str(empty))
    else:
        bad = tmp_path / "query_body.cpp"
        bad.write_text("int broken = ;\n")
        monkeypatch.setattr(query_body.LIBRARY, "source", bad)
    monkeypatch.setattr(query_body.LIBRARY, "out_dir", tmp_path / "build")
    monkeypatch.setattr(query_body.LIBRARY, "lib", None)
    monkeypatch.setattr(query_body.LIBRARY, "_failed", False)
    warnings = []
    monkeypatch.setattr(_build.logger, "warning",
                        lambda *a, **k: warnings.append(a))

    async def go():
        rows = None
        replies = []
        for _ in range(2):          # a second start-up tries no more
            async with make_client(tmp_path / f"app{len(replies)}") as client:
                rows = await fill(client)
                before = counts()
                replies.append(await answer(
                    client, "/vectors/query",
                    q(json.dumps(rows[9].tolist()), k="1")))
                assert counts()[0] == before[0]
                assert counts()[1] == before[1] + 1
        return replies
    replies = asyncio.run(go())
    assert not query_body.load()           # tried once a process
    assert len(warnings) == 1
    for status, reply in replies:
        assert status == 200
        assert reply["results"][0]["index"] == 9
