"""The int8 capacity deployment (the benchmark's ``cohere768-8m-int8``:
int8 cosine rows, ``batch_query(..., rerank=True)``) at a few thousand
rows of its seeded mixture on the CPU: the store against the plain
reference ``benchmark_h100/reference_int8.py``, recall against exact
float32, the benchmark's ``sim_err`` limit with the refine and without
it, and what the deployment adds to the tracer (the ``store.rerank``
span; ``chunks`` on ``store.scan``). The ``gpu`` cases hold the card's
chunked big-k scan to its one-chunk scan, and the store on the card to
the reference."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_h100 import datagen, reference, reference_int8, server, verdict
from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops import cuda_scan
from tpu_vector_db_torch import VectorStoreConfig
from tpu_vector_db_torch.store.vector_store import TorchVectorStore

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_h100" / "configs" /
                     "cohere768-8m-int8.json").read_text())
N, D, P, K = 4096, 768, 64, 10
SEED = 2**31 + 18
OVERSAMPLE = 4          # the store's default rerank_oversample


def make_store(path, rows, device="cpu"):
    store = TorchVectorStore(path, server.store_config(CONFIG),
                             device=device)
    store.add_vectors(rows.cpu().numpy())
    return store


def answer_arrays(out):
    return (np.array([ids for ids, _, _ in out], np.int64),
            np.array([sims for _, sims, _ in out], np.float64))


def judge(out, rows, pool):
    """The benchmark's checks of the answers ``out`` to every pool query."""
    answers = verdict.Answers(K)
    for q, (ids, sims, _) in enumerate(out):
        answers.add(q, ids, sims)
    ref = reference.Reference(rows, pool)
    try:
        return verdict.judge(answers, ref, rows.shape[0], CONFIG)
    finally:
        ref.close()


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    rows = datagen.rows(CONFIG["data"], N, D, SEED, "cpu")
    pool = datagen.query_pool(CONFIG["data"], P, D, SEED, "cpu")
    store = make_store(tmp_path_factory.mktemp("int8") / "s", rows)
    yield rows, pool, store
    store.close()


@pytest.fixture
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def test_the_deployment_is_the_stores_int8_rerank_path(deployment):
    _, _, store = deployment
    assert store.config.storage_dtype == "int8"
    assert not store.config.enable_ann
    assert store.config.ann_params.get("rerank_oversample",
                                       OVERSAMPLE) == OVERSAMPLE


def test_rerank_matches_the_plain_reference(deployment):
    """Ids as the reference's, in order, but where the reference shows a
    near-tie (the 40th and 41st int8 keys, or two refined scores, within
    float32 rounding); every shared id's score within 1e-6."""
    rows, pool, store = deployment
    ids, sims = answer_arrays(store.batch_query(pool.numpy(), k=K,
                                                rerank=True))
    ref = reference_int8.Int8Reference(rows)
    try:
        ans = ref.search(pool, K, OVERSAMPLE)
    finally:
        ref.close()
    agree = reference_int8.agreement(ids, sims, ans)
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= 1e-6
    assert agree["same"].sum() >= P - 2, int(agree["near_tie"].sum())


def test_the_reference_quantizes_as_the_store_does(deployment):
    rows, _, store = deployment
    ref = reference_int8.Int8Reference(rows)
    ref.close()
    assert torch.equal(ref.codes, store._db[:N])


def test_rerank_meets_the_recall_floor_and_sim_err(deployment):
    rows, pool, store = deployment
    checks, recall = judge(store.batch_query(pool.numpy(), k=K,
                                             rerank=True), rows, pool)
    assert verdict.all_ok(checks), checks
    assert recall >= CONFIG["guarantees"]["recall_at_k_min"]
    assert checks["sim_err"]["value"] <= 1e-6


def test_without_the_refine_sim_err_fails(deployment):
    """The int8 keys themselves are ~1e-3 from the cosine: the limit of
    2e-5 on the similarities returned is what makes the refine count."""
    rows, pool, store = deployment
    checks, _ = judge(store.batch_query(pool.numpy(), k=K), rows, pool)
    assert checks["sim_err"]["value"] > 20 * CONFIG["limits"]["sim_err"]
    assert not checks["sim_err"]["ok"]
    assert not verdict.all_ok(checks)


def test_rerank_span_one_a_call(deployment, fresh_tracer):
    _, pool, store = deployment
    q = pool.numpy()
    with profile(activities=[ProfilerActivity.CPU]):
        store.batch_query(q, k=K, rerank=True)
        store.batch_query(q[:5], k=K, rerank=True)
        store.batch_query(q, k=K)
    spans = tracing.spans()
    rerank = [s for s in spans if s["name"] == "store.rerank"]
    assert [s["attrs"] for s in rerank] == [
        {"queries": P, "candidates": P * K * OVERSAMPLE},
        {"queries": 5, "candidates": 5 * K * OVERSAMPLE}]
    calls = {s["id"]: s for s in spans if s["name"] == "store.batch_query"}
    assert [calls[s["parent"]]["attrs"]["k"] for s in rerank] == [K, K]
    scans = [s["attrs"]["k"] for s in spans if s["name"] == "store.scan"]
    assert scans == [K * OVERSAMPLE, K * OVERSAMPLE, K]
    assert tracing.summary()["spans"]["store.rerank"]["count"] == 2


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_rerank_scores_ragged_candidate_lists(tmp_path, metric):
    """One call re-scores rows of different candidate counts (an empty
    one too, and candidates scattered among entries it skips): each row
    gets the best k of its own candidates, ids and metadata in order,
    scores within 1e-6 of their float64 values."""
    rng = np.random.default_rng(18)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    store = TorchVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=32, metric=metric, storage_dtype="bfloat16",
        persist_mode="off"), device="cpu")
    store.add_vectors(x, [{"i": i} for i in range(len(x))])
    q = rng.standard_normal((4, 32)).astype(np.float32)
    ids = np.stack([rng.choice(len(x), 40, replace=False)
                    for _ in range(4)])
    keep = np.zeros((4, 40), bool)
    keep[0] = True
    keep[1, rng.choice(40, 7, replace=False)] = True
    keep[3, :23] = True
    keys, got_ids, valid = store._rerank_exact(q, ids, keep, 5)
    out = store._format_batch(keys, got_ids, 5, valid, None)
    for r, (got_i, got_s, got_m) in enumerate(out):
        cands = ids[r][keep[r]]
        rows, qv = x[cands].astype(np.float64), q[r].astype(np.float64)
        if metric == "cosine":
            want = np.clip(rows @ qv / np.linalg.norm(rows, axis=1)
                           / np.linalg.norm(qv), -1, 1)
        elif metric == "euclidean":
            want = -np.linalg.norm(rows - qv, axis=1)
        else:
            want = rows @ qv
        best = np.argsort(-want, kind="stable")[:5]
        assert got_i == cands[best].tolist()
        assert got_m == [{"i": i} for i in got_i]
        np.testing.assert_allclose(
            got_s, np.abs(want[best]) if metric == "euclidean"
            else want[best], atol=1e-6, rtol=1e-6)
    assert out[2] == ([], [], [])
    store.close()


@pytest.mark.parametrize("filt", [None, {"g": 3}])
def test_rerank_refines_the_answers_the_scan_gives(tmp_path, filt):
    """With a filter and tombstones: rerank=True answers the best k of the
    4k answers the same call without rerank gives, re-scored in f32."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    store = TorchVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=64, metric="cosine", storage_dtype="int8",
        persist_mode="off"), device="cpu")
    store.add_vectors(x, [{"g": i % 5} for i in range(len(x))])
    q = rng.standard_normal((16, 64)).astype(np.float32)
    first = store.batch_query(q, k=K, filter_metadata=filt)
    store.delete_vectors([int(r[0][0]) for r in first[:4]])
    cands = store.batch_query(q, k=K * OVERSAMPLE, filter_metadata=filt)
    got = store.batch_query(q, k=K, rerank=True, filter_metadata=filt)
    for qv, (ids, _, _), (got_i, got_s, got_m) in zip(q, cands, got):
        qv = qv.astype(np.float64)
        rows = x[ids].astype(np.float64)
        want = (rows @ qv / np.linalg.norm(rows, axis=1)
                / np.linalg.norm(qv))
        best = np.argsort(-want, kind="stable")[:K]
        assert got_i == [ids[j] for j in best]
        assert got_m == [{"g": i % 5} for i in got_i]
        if filt:
            assert all(m == filt for m in got_m)
        np.testing.assert_allclose(got_s, want[best], atol=1e-6, rtol=0)
    # the candidates are the first 4k valid entries that pass the exact
    # re-check (the scan's filter mask is hash-based)
    ids = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    valid = np.ones((2, 40), bool)
    valid[1, ::2] = False
    keep = store._candidates(ids, valid, 4, filt)
    match = (ids % 5 == 3) if filt else np.ones_like(valid)
    want = valid & match
    want &= np.cumsum(want, axis=1) <= 4
    np.testing.assert_array_equal(keep, want)
    store.close()


class _FakeLib:
    """Stands in for the built library: launches nothing."""

    def vdb_flat_scratch_bytes(self, q_n, k, count, chunk_rows):
        return 1024 if k > cuda_scan.MAX_K_SMALL and chunk_rows else 0

    def vdb_flat_topk(self, *args):
        return 0


@pytest.mark.parametrize("k,budget,chunks", [
    (40, cuda_scan.KEY_SCRATCH_BYTES, 1),
    (40, 64 * 2816 * 4, 4),
    (10, cuda_scan.KEY_SCRATCH_BYTES, None)])
def test_scan_span_carries_the_chunks(monkeypatch, fresh_tracer, k, budget,
                                      chunks):
    """``chunks`` on the caller's span: the row chunks the key-scratch
    plan merged (64 queries over 10,000 rows through the row loop, which
    keeps the key scratch at every k > 32: one chunk at the default key
    scratch, four at a budget of 2,816 rows a query), beside ``select``
    ``radix``; neither for k <= 32."""
    monkeypatch.setattr(cuda_scan.LIBRARY, "lib", _FakeLib())
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (9, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    db = torch.zeros((10000, 128), dtype=torch.int8)
    q = torch.zeros((64, 128))
    plan = cuda_scan._plan("loop", 64, torch.int8, 128, k, 10000,
                           budget=budget)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("store.scan", k=k):
            cuda_scan._launch(q, db, 128, 10000, k, "cosine", None, None,
                              None, plan)
        cuda_scan._launch(q, db, 128, 10000, k, "cosine", None, None, None,
                          plan)      # no span open: nothing to annotate
    (scan,) = tracing.spans()
    assert scan["attrs"].get("chunks") == chunks
    assert scan["attrs"].get("select") == ("radix" if chunks else None)
    if chunks:
        assert plan.n_lists == chunks


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_chunked_big_k_equals_one_chunk_on_card(fresh_tracer):
    """The cell's scan (int8 rows, 64 queries, k = 40: the tile's lists)
    against the key-scratch path at k = 100, in one chunk and with the
    budget cut so that the rows go in four chunks that merge_topk_kernel
    combines: the first 40 keys and ids the same, bit for bit (a row's
    key depends on neither its chunk nor the select), and on the scan's
    span ``select`` lists, radix, radix and ``chunks`` none, 1, 4."""
    _need_card()
    n, d, q_n, k = 100_000, 768, 64, 40
    rows = datagen.rows(CONFIG["data"], n, d, SEED, "cuda")
    db = torch.clamp(torch.round(rows * 127.0), -127, 127).to(torch.int8)
    q = datagen.query_pool(CONFIG["data"], q_n, d, SEED, "cuda")
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        for kk, budget in ((k, cuda_scan.KEY_SCRATCH_BYTES),
                           (100, cuda_scan.KEY_SCRATCH_BYTES),
                           (100, q_n * 25_600 * 4)):
            plan = cuda_scan._launch_plan(q_n, db.dtype, d, kk, n,
                                          budget=budget)
            with tracing.span("store.scan", k=kk):
                keys, ids = cuda_scan._launch(q, db, d, n, kk, "cosine",
                                              None, None, None, plan)
            torch.cuda.synchronize()
            got.append((keys[:, :k].cpu(), ids[:, :k].cpu()))
    for keys, ids in got[1:]:
        assert torch.equal(got[0][0].view(torch.int32), keys.view(torch.int32))
        assert torch.equal(got[0][1], ids)
    spans = tracing.spans()
    assert [s["attrs"]["select"] for s in spans] == ["lists", "radix",
                                                     "radix"]
    assert [s["attrs"].get("chunks") for s in spans] == [None, 1, 4]


@pytest.mark.gpu
def test_rerank_matches_the_plain_reference_on_card(tmp_path):
    """The store on the card (the tensor-core tile over int8 rows, the
    big-k select, the host refine) against the reference on the card, at
    262,144 rows and 256 queries."""
    _need_card()
    n, q_n = 262_144, 256
    rows = datagen.rows(CONFIG["data"], n, D, SEED, "cuda")
    pool = datagen.query_pool(CONFIG["data"], q_n, D, SEED, "cuda")
    store = make_store(tmp_path / "s", rows, device="cuda")
    ids, sims = [], []
    for s in range(0, q_n, 64):
        i, v = answer_arrays(store.batch_query(pool[s:s + 64].cpu().numpy(),
                                               k=K, rerank=True))
        ids.append(i)
        sims.append(v)
    store.close()
    ref = reference_int8.Int8Reference(rows)
    try:
        ans = ref.search(pool, K, OVERSAMPLE)
    finally:
        ref.close()
    agree = reference_int8.agreement(np.concatenate(ids),
                                     np.concatenate(sims), ans)
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= 1e-6
    assert agree["same"].mean() >= 0.95, int(agree["near_tie"].sum())
