"""The IVF_SQ8 + refine deployment (the benchmark's
``cohere768-8m-ivf-int8``: int8 cosine rows behind the gather-layout
IVF, ``batch_query(..., rerank=True)`` with ``ivf_gather_large_k``) at
16,384 rows of its seeded mixture on the CPU: the store against the
plain reference ``benchmark_h100/reference_ivf_int8.py``, the route the
key opens and the routes it leaves as they were, recall against exact
float32, the benchmark's ``sim_err`` limit without the refine, and what
the route adds to the tracer (``layout``, ``nprobe`` and ``bucket_rows``
on ``index.search``; the ``index.probe`` span). Then the gather layout's
kernel (``ops/ivf_scan.py::ivf_gather_topk``): its plan on the CPU, and on
the card (``gpu``) bit for bit against its plain version where every key
is exact in any summation order, and the store on the card against the
reference."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_h100 import (datagen, reference, reference_ivf_int8, server,
                            verdict)
from tpu_vector_db_torch.index import ivf
from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops import ivf_scan
from tpu_vector_db_torch.ops.launches import LAUNCHES
from tpu_vector_db_torch.store.vector_store import TorchVectorStore

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_h100" / "configs" /
                     "cohere768-8m-ivf-int8.json").read_text())
N, D, P, K, B = 16384, 768, 64, 10, 16
SEED = 2**31 + 22
OVERSAMPLE = 4          # the store's default rerank_oversample
CLUSTERS, NPROBE = 64, 8


def store_config(**params):
    cfg = server.store_config(CONFIG)
    cfg.ann_params.update(n_clusters=CLUSTERS, nprobe=NPROBE, **params)
    return cfg


def answer_arrays(out):
    return (np.array([ids for ids, _, _ in out], np.int64),
            np.array([sims for _, sims, _ in out], np.float64))


def in_calls(store, pool, **kw):
    """The pool's answers in b16 calls."""
    out = []
    for s in range(0, len(pool), B):
        out += store.batch_query(pool[s:s + B], **kw)
    return out


def spy_ann(store):
    calls = {"n": 0}
    orig = store._ann_search

    def spy(q, k):
        calls["n"] += 1
        return orig(q, k)
    store._ann_search = spy
    return calls


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    rows = datagen.rows(CONFIG["data"], N, D, SEED, "cpu")
    pool = datagen.query_pool(CONFIG["data"], P, D, SEED, "cpu")
    store = TorchVectorStore(tmp_path_factory.mktemp("ivfsq8") / "s",
                             store_config(), device="cpu")
    store.add_vectors(rows.numpy())
    yield rows, pool, store
    store.close()


@pytest.fixture
def key(deployment):
    """Sets the store's ``ivf_gather_large_k`` for one test."""
    params = deployment[2].config.ann_params

    def set_key(on: bool):
        params["ivf_gather_large_k"] = on
    yield set_key
    params["ivf_gather_large_k"] = True


@pytest.fixture
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def test_the_deployment_is_the_gather_layout_with_the_key_on(deployment):
    _, _, store = deployment
    assert store.config.storage_dtype == "int8"
    assert store.config.ann_params["ivf_gather_large_k"] is True
    assert store.get_stats()["index_type"] == "ivf"
    assert store._ann._gather_layout(store._db)
    assert store._ann.get_stats()["clusters"] == CLUSTERS


def test_rerank_matches_the_plain_reference(deployment):
    """Ids as the reference's, in order, but where the reference shows a
    near-tie (the 40th and 41st int8 keys, two refined scores, or the
    last bucket probed and the next, within float32 rounding); every
    shared id's score within 1e-6."""
    rows, pool, store = deployment
    calls = spy_ann(store)
    ids, sims = answer_arrays(in_calls(store, pool.numpy(), k=K,
                                       rerank=True))
    assert calls["n"] == P // B
    del store._ann_search
    index = store._ann
    ref = reference_ivf_int8.IvfInt8Reference(
        rows, index._centroids, index._ids, index._bucket_cluster,
        index.nprobe)
    try:
        ans = ref.search(pool, K, OVERSAMPLE)
    finally:
        ref.close()
    agree = reference_ivf_int8.agreement(ids, sims, ans, ref.bucket_margin)
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= 1e-6
    assert agree["same"].sum() >= P - 2, int(agree["near_tie"].sum())


def test_key_off_takes_the_exact_scan_as_the_jax_store_does(deployment, key):
    """With the key at its default, k = 10 with rerank fetches 40, past
    32: the exact scan answers, as it does with use_ann=False."""
    _, pool, store = deployment
    key(False)
    q = pool.numpy()
    calls = spy_ann(store)
    got = in_calls(store, q, k=K, rerank=True)
    assert calls["n"] == 0
    del store._ann_search
    assert got == in_calls(store, q, k=K, rerank=True, use_ann=False)


@pytest.mark.parametrize("k, rerank", [(8, True), (5, False), (32, False)])
def test_key_on_leaves_fetches_of_32_or_fewer_as_they_were(deployment, key,
                                                           k, rerank):
    _, pool, store = deployment
    q = pool.numpy()
    calls = spy_ann(store)
    on = in_calls(store, q, k=k, rerank=rerank)
    key(False)
    off = in_calls(store, q, k=k, rerank=rerank)
    del store._ann_search
    assert calls["n"] == 2 * P // B
    assert on == off


@pytest.mark.parametrize("k, fetched", [(16, 64), (17, 68)])
def test_key_on_serves_up_to_64_and_sends_more_to_the_exact_scan(
        deployment, k, fetched):
    """The gather kernel's lists stop at 64: k = 16 with rerank (64
    candidates) stays on the index, k = 17 (68) takes the exact scan,
    whatever the key says."""
    _, pool, store = deployment
    q = pool.numpy()[:B]
    calls = spy_ann(store)
    got = store.batch_query(q, k=k, rerank=True)
    del store._ann_search
    assert calls["n"] == (1 if fetched <= 64 else 0)
    if fetched > 64:
        assert got == store.batch_query(q, k=k, rerank=True, use_ann=False)


def test_a_bucketized_index_sends_past_32_to_the_exact_scan(tmp_path):
    """An f32 store's IVF is bucketized: its probe kernel stops at k =
    32, so the key leaves its routing as it was."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    cfg = server.store_config(CONFIG)
    cfg.dimension, cfg.storage_dtype = 32, "float32"
    cfg.ann_params.update(n_clusters=8, nprobe=4, self_check=False)
    store = TorchVectorStore(tmp_path / "s", cfg, device="cpu")
    store.add_vectors(x)
    assert not store._ann._gather_layout(store._db)
    calls = spy_ann(store)
    got = store.batch_query(x[:4], k=40)
    assert calls["n"] == 0
    store.batch_query(x[:4], k=10)
    assert calls["n"] == 1
    del store._ann_search
    assert got == store.batch_query(x[:4], k=40, use_ann=False)
    store.close()


def test_rerank_meets_the_recall_floor(deployment):
    """recall@10 against exact float32 cosine, and the benchmark's
    checks of every answer."""
    rows, pool, store = deployment
    out = in_calls(store, pool.numpy(), k=K, rerank=True)
    ids, _ = answer_arrays(out)
    r = rows.numpy().astype(np.float64)
    q = pool.numpy().astype(np.float64)
    cos = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        r / np.linalg.norm(r, axis=1, keepdims=True)).T
    exact = np.argsort(-cos, axis=1, kind="stable")[:, :K]
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                    exact.tolist()))
    assert hits / (P * K) >= 0.95, hits / (P * K)
    answers = verdict.Answers(K)
    for i, (got_ids, sims, _) in enumerate(out):
        answers.add(i, got_ids, sims)
    ref = reference.Reference(rows, pool)
    try:
        checks, recall = verdict.judge(answers, ref, N, CONFIG)
    finally:
        ref.close()
    assert verdict.all_ok(checks), checks
    assert recall >= CONFIG["guarantees"]["recall_at_k_min"]


def test_without_the_refine_sim_err_fails(deployment):
    """The IVF's int8 keys are ~1e-3 from the float64 cosine: the limit
    of 2e-5 is what makes the refine count."""
    rows, pool, store = deployment
    out = in_calls(store, pool.numpy(), k=K)
    ids, sims = answer_arrays(out)
    r = rows.numpy().astype(np.float64)[ids]
    q = pool.numpy().astype(np.float64)
    cos = np.einsum("qkd,qd->qk", r / np.linalg.norm(r, axis=2,
                                                     keepdims=True),
                    q / np.linalg.norm(q, axis=1, keepdims=True))
    assert np.abs(sims - cos).max() > CONFIG["limits"]["sim_err"]


def test_the_tracer_sees_the_gather_probe(deployment, fresh_tracer):
    """``index.search`` carries the layout, the nprobe used and the
    bucket rows; its child ``index.probe`` the live rows it scored (the
    probed buckets' fills) and its slots (Q x nprobe x bucket rows)."""
    _, pool, store = deployment
    q = pool.numpy()[:B]
    with profile(activities=[ProfilerActivity.CPU]):
        store.batch_query(q, k=K, rerank=True)
    spans = {s["name"]: s for s in tracing.spans()}
    search, probe = spans["index.search"], spans["index.probe"]
    index = store._ann
    bc = index._ids.shape[1]
    assert search["attrs"] == {"k": K * OVERSAMPLE, "layout": "gather",
                               "nprobe": index.nprobe, "bucket_rows": bc}
    assert probe["parent"] == search["id"]
    dev = index._dev
    sel = ivf._select_buckets(store._prepare_queries(q), dev["centroids"],
                              dev["bucket_cluster"], index.nprobe, "cosine",
                              dev["c_sqnorms"])
    fills = bc - index._free
    assert probe["attrs"] == {"slots": B * index.nprobe * bc,
                              "rows": int(fills[sel.numpy()].sum())}
    assert 0 < probe["attrs"]["rows"] <= probe["attrs"]["slots"]


# ------------------------------------------------ the gather-layout kernel


class _FakeGatherLib:
    """Stands in for the built library: records the launch, runs nothing."""

    def __init__(self) -> None:
        self.calls = []

    def vdb_ivf_gather_topk(self, *args):
        self.calls.append(args)
        return 0


def test_the_gather_probe_on_the_cpu_is_its_plain_version():
    rng = np.random.default_rng(7)
    db = torch.from_numpy(rng.integers(-127, 128, (600, 128), np.int8))
    ids = torch.from_numpy(rng.permutation(640).reshape(10, 64)
                           .astype(np.int32))
    ids = torch.where(ids < 600, ids, torch.full_like(ids, -1))
    fills = (ids >= 0).sum(1).to(torch.int32)
    ids = torch.sort(ids, dim=1, descending=True).values  # live slots first
    q = torch.from_numpy(rng.standard_normal((3, 128)).astype(np.float32))
    sel = torch.tensor([[0, 3, 5], [9, 1, 2], [4, 5, 7]],
                       dtype=torch.int32)
    before = dict(LAUNCHES)
    got = ivf_scan.ivf_gather_topk(q, db, ids, fills, sel, 40)
    assert LAUNCHES == before                   # no kernel on the CPU
    want = ivf_scan.ivf_probe_topk_gather(q, db, ids, sel, 40)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_one_gather_launch_for_the_cells_call(monkeypatch):
    """The cell's call (16 queries, nprobe 32, buckets of 2,048 slots, k =
    40): one library call, each bucket in 3 slices (16 x 32 x 3 = 1,536
    blocks, about the 1,056 the kernel aims for), int8 rows by their
    code, a launch counted."""
    fake = _FakeGatherLib()
    monkeypatch.setattr(ivf_scan.LIBRARY, "lib", fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    db = torch.zeros((4096, 768), dtype=torch.int8)
    ids = torch.full((40, 2048), -1, dtype=torch.int32)
    fills = torch.zeros(40, dtype=torch.int32)
    sel = torch.zeros((16, 32), dtype=torch.int32)
    q = torch.zeros((16, 768))
    n0 = LAUNCHES["ivf_gather_kernel"]
    keys, out = ivf_scan._gather_launch(q, db, ids, fills, sel, 40)
    assert LAUNCHES["ivf_gather_kernel"] == n0 + 1
    (args,) = fake.calls
    (_, q_n, d_pad, _, code, scales, nb, bc, _, nprobe, _, _, k, splits,
     *_rest) = args
    assert (q_n, d_pad, code, scales, nb, bc, nprobe, k, splits) == (
        16, 768, 2, None, 40, 2048, 32, 40, 3)
    assert keys.shape == out.shape == (16, 40)


def test_int4_rows_launch_with_their_scales(monkeypatch):
    """uint8-packed int4 rows (two components a byte): the query's
    d_pad is twice the row's bytes, the rows go by code 3 with their
    per-row scales."""
    fake = _FakeGatherLib()
    monkeypatch.setattr(ivf_scan.LIBRARY, "lib", fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    db = torch.zeros((4096, 384), dtype=torch.uint8)
    scales = torch.ones(4096)
    ids = torch.full((40, 2048), -1, dtype=torch.int32)
    fills = torch.zeros(40, dtype=torch.int32)
    sel = torch.zeros((1, 32), dtype=torch.int32)
    ivf_scan._gather_launch(torch.zeros((1, 768)), db, ids, fills, sel, 10,
                            scales)
    (args,) = fake.calls
    assert (args[2], args[4], args[12]) == (768, 3, 10)
    assert args[5] is not None


def test_the_gather_probe_refuses_euclidean():
    db = torch.zeros((64, 128), dtype=torch.int8)
    ids = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="cosine/dot"):
        ivf_scan.ivf_gather_topk(torch.zeros((1, 128)), db, ids,
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.zeros((1, 1), dtype=torch.int32), 5,
                                 metric="euclidean")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _exact_layout(seed, dtype, n=40_000, d=768, nb=64, bc=512, q_n=16,
                  nprobe=8):
    """Rows of small integers and queries of small multiples of 1/8 on the
    card, so that every key is exact in float32 in any summation order
    (and ties are many): buckets of random fills, one empty and one full,
    and each query's nprobe distinct buckets."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(-4, 5, (n, d), generator=g, dtype=torch.int8)
    fills = torch.randint(0, bc + 1, (nb,), generator=g)
    fills[0], fills[1] = 0, bc
    perm = torch.randperm(n, generator=g)
    ids = torch.full((nb, bc), -1, dtype=torch.int32)
    at = 0
    for b in range(nb):
        f = int(fills[b])
        ids[b, :f] = perm[at:at + f].to(torch.int32)
        at += f
    q = torch.randint(-16, 17, (q_n, d), generator=g).float() / 8
    sel = torch.stack([torch.randperm(nb, generator=g)[:nprobe]
                       for _ in range(q_n)]).to(torch.int32)
    scales = None
    if dtype == torch.uint8:
        # int4: nibbles 0..15, component j low and j + d/2 high in byte
        # j, scales powers of two
        nib = torch.randint(0, 16, (n, d), generator=g, dtype=torch.int32)
        db = (nib[:, :d // 2] | (nib[:, d // 2:] << 4)).to(torch.uint8)
        scales = 2.0 ** torch.randint(-3, 2, (n,), generator=g).float()
        scales = scales.to("cuda")
    else:
        db = rows if dtype == torch.int8 else rows.to(torch.bfloat16)
    card = "cuda"
    return (q.to(card), db.to(card), ids.to(card),
            fills.to(torch.int32).to(card), sel.to(card), scales)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("q_n, k", [(1, 1), (1, 10), (16, 32), (16, 33),
                                    (16, 40), (5, 40), (64, 64)])
def test_the_gather_kernel_equals_its_plain_version_on_card(dtype, q_n, k):
    """Keys exact in any summation order: the kernel's keys and ids equal
    the plain probe's bit for bit, ties to the lower id, -inf / -1 past
    the live rows (an empty bucket, and k past a query's live rows at
    q_n 1); int8, bf16 and uint8-packed int4 rows."""
    _need_card()
    q, db, ids, fills, sel, scales = _exact_layout(2200 + k, dtype, q_n=q_n)
    n0 = LAUNCHES["ivf_gather_kernel"]
    keys, got = ivf_scan.ivf_gather_topk(q, db, ids, fills, sel, k,
                                         db_scales=scales)
    torch.cuda.synchronize()
    assert LAUNCHES["ivf_gather_kernel"] == n0 + 1
    want_keys, want = ivf_scan.ivf_probe_topk_gather(q, db, ids, sel, k,
                                                     db_scales=scales)
    assert torch.equal(keys.view(torch.int32), want_keys.view(torch.int32))
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_the_gather_kernel_refuses_past_64_on_card():
    """On the card no k past the kernel's lists falls back to the plain
    probe: the store sends such a fetch to the exact scan."""
    _need_card()
    q, db, ids, fills, sel, _ = _exact_layout(2265, torch.int8, q_n=2)
    with pytest.raises(ValueError, match="k <= 64"):
        ivf_scan.ivf_gather_topk(q, db, ids, fills, sel, 65)


@pytest.mark.gpu
def test_the_gather_kernel_past_the_live_rows_on_card():
    """A query whose probed buckets hold fewer live rows than k: the
    rest of its answer is -inf / -1, as the plain probe gives."""
    _need_card()
    q, db, ids, fills, sel, _ = _exact_layout(2299, torch.int8, q_n=2,
                                              nprobe=2)
    fills_h = fills.cpu()
    few = int(torch.nonzero((fills_h > 0) & (fills_h < 40))[0, 0])
    # the empty bucket 0 and one of fewer than 40 live rows
    sel[0] = torch.tensor([0, few], dtype=torch.int32, device="cuda")
    live = int(fills_h[few])
    k = live + 5
    keys, got = ivf_scan.ivf_gather_topk(q, db, ids, fills, sel, k)
    want_keys, want = ivf_scan.ivf_probe_topk_gather(q, db, ids, sel, k)
    assert torch.equal(keys.view(torch.int32), want_keys.view(torch.int32))
    assert torch.equal(got, want)
    assert (got[0, live:] == -1).all()


@pytest.mark.gpu
def test_the_store_on_card_matches_the_plain_reference(tmp_path):
    """The deployment on the card (the gather kernel at k = 40, the refine
    on the card) against the reference on the card, at 262,144 rows,
    1,024 clusters, nprobe 8 and 128 queries in b16 calls."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    n, q_n = 262_144, 128
    rows = datagen.rows(CONFIG["data"], n, D, SEED, "cuda")
    pool = datagen.query_pool(CONFIG["data"], q_n, D, SEED, "cuda")
    cfg = server.store_config(CONFIG)
    cfg.ann_params.update(n_clusters=1024, nprobe=8)
    store = TorchVectorStore(tmp_path / "s", cfg, device="cuda")
    store.add_vectors(rows.cpu().numpy())
    n0 = LAUNCHES["ivf_gather_kernel"]
    ids, sims = answer_arrays(in_calls(store, pool.cpu().numpy(), k=K,
                                       rerank=True))
    assert LAUNCHES["ivf_gather_kernel"] == n0 + q_n // B
    index = store._ann
    layout = (index._centroids, index._ids, index._bucket_cluster,
              index.nprobe)
    store.close()
    ref = reference_ivf_int8.IvfInt8Reference(rows, *layout)
    try:
        ans = ref.search(pool, K, OVERSAMPLE)
    finally:
        ref.close()
    agree = reference_ivf_int8.agreement(ids, sims, ans, ref.bucket_margin)
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= 1e-6
    assert agree["same"].mean() >= 0.95
