"""The ANN store on both packages: TorchVectorStore (device="cpu") and
TPUVectorStore run the cases of tests/test_auto_routing.py,
tests/test_quant_ivf.py and tests/test_ivf.py that need no sharding, each
test once per store; the two stores answer the same sequence of
operations alike; and an ``ann_ivf.npz`` written by either package is
served by the other without a rebuild.

Tolerances: scores to 1e-4 between the two stores (f32 sums in another
order), 6e-3 between an ANN and an exact answer on a bf16/int8/int4 store
(the JAX tests' bf16 scoring tolerance), ids equal away from near-ties.
"""

import numpy as np
import pytest
import torch

from tpu_vector_db.index.ivf import IVFIndex as JaxIVF
from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.store.vector_store import TPUVectorStore

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.index.ivf import IVFIndex

torch.set_num_threads(1)

STORES = ["jax", "torch"]


def make_store(which, path, **cfg):
    if which == "jax":
        return TPUVectorStore(path, JaxConfig(**cfg))
    return TorchVectorStore(path, VectorStoreConfig(**cfg), device="cpu")


def reopen(which, path):
    return (TPUVectorStore(path) if which == "jax"
            else TorchVectorStore(path, device="cpu"))


def clustered(rng, n, d, centers=16, spread=0.08):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    pts = c[rng.integers(0, centers, n)] + \
        spread * rng.standard_normal((n, d)).astype(np.float32)
    return pts.astype(np.float32)


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def make_auto_store(which, path, rng, n, d=32, flat_rows=500, **extra):
    store = make_store(
        which, path, dimension=d, metric="cosine", enable_ann=True,
        persist_mode="off",
        ann_params={"auto_flat_rows": flat_rows, "n_clusters": 16,
                    "nprobe": 16, "self_check": False, **extra})
    x = clustered(rng, n, d)
    store.add_vectors(x, [{"i": i} for i in range(n)])
    return store, x


def spy_ann(store):
    calls = {"n": 0}
    orig = store._ann_batch_query

    def wrapper(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    store._ann_batch_query = wrapper
    return calls


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# ----------------------------------------------- auto routing (both stores)

@pytest.mark.parametrize("which", STORES)
def test_small_store_stays_flat(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=300)
    assert store._ann is None
    assert store.get_stats()["index_type"] == "flat"
    assert store.get_stats()["index_type_requested"] == "auto"
    ids, scores, _ = store.query(x[17], k=3)
    assert ids[0] == 17 and scores[0] > 0.999


@pytest.mark.parametrize("which", STORES)
def test_large_store_resolves_ivf(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=1200)
    assert store.get_stats()["index_type"] == "ivf"
    calls = spy_ann(store)
    ids, scores, _ = store.query(x[41], k=5)
    assert calls["n"] == 1, "batch-1 above crossover must use IVF"
    assert ids[0] == 41 and scores[0] > 0.99


@pytest.mark.parametrize("which", STORES)
def test_growth_promotes_flat_to_ivf(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=300)
    assert store.get_stats()["index_type"] == "flat"
    more = clustered(rng, 400, 32)
    store.add_vectors(more)
    assert store.get_stats()["index_type"] == "ivf"
    ids, _, _ = store.query(more[10], k=1)
    assert ids[0] == 310


@pytest.mark.parametrize("which", STORES)
def test_optimize_reroutes_after_clear(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=1200)
    assert store.get_stats()["index_type"] == "ivf"
    store.clear()
    store.add_vectors(clustered(rng, 100, 32))
    store.optimize()
    assert store.get_stats()["index_type"] == "flat"


@pytest.mark.parametrize("which", STORES)
def test_explicit_flat_never_builds(tmp_path, rng, which):
    store = make_store(which, tmp_path / "s", dimension=16, enable_ann=True,
                       persist_mode="off", ann_params={"index_type": "flat"})
    store.add_vectors(clustered(rng, 800, 16))
    assert store._ann is None


@pytest.mark.parametrize("which", STORES)
def test_high_batch_routes_to_exact(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=1200)
    calls = spy_ann(store)
    res = store.batch_query(x[:32], k=5)
    assert calls["n"] == 0, "batch >= 32 below crossover must go exact"
    assert all(res[i][0][0] == i for i in range(32))
    store.batch_query(x[:4], k=5)
    assert calls["n"] == 1, "low batch keeps the IVF path"


@pytest.mark.parametrize("which", STORES)
def test_explicit_ivf_keeps_index_at_high_batch(tmp_path, rng, which):
    store = make_store(which, tmp_path / "s", dimension=32, enable_ann=True,
                       persist_mode="off",
                       ann_params={"index_type": "ivf", "n_clusters": 16,
                                   "nprobe": 16, "self_check": False})
    x = clustered(rng, 1200, 32)
    store.add_vectors(x)
    calls = spy_ann(store)
    store.batch_query(x[:32], k=5)
    assert calls["n"] == 1, "operator's explicit choice is respected"


@pytest.mark.parametrize("which", STORES)
def test_low_selectivity_filter_routes_to_exact(tmp_path, rng, which):
    store = make_store(which, tmp_path / "s", dimension=32, metric="cosine",
                       enable_ann=True, persist_mode="off",
                       ann_params={"index_type": "ivf", "n_clusters": 16,
                                   "nprobe": 2, "self_check": False})
    x = clustered(rng, 1500, 32)
    rare = set(range(0, 1000, 100))
    store.add_vectors(x, [
        {"tag": "rare" if i in rare else "common"} for i in range(1500)])
    calls = spy_ann(store)
    ids, scores, metas = store.query(x[0], k=10,
                                     filter_metadata={"tag": "rare"})
    assert calls["n"] == 0, "low-selectivity filter must go exact"
    assert set(ids) == rare
    assert all(m["tag"] == "rare" for m in metas)
    store.query(x[0], k=3, filter_metadata={"tag": "common"})
    assert calls["n"] == 1


@pytest.mark.parametrize("which", STORES)
def test_auto_recall_gate(tmp_path, rng, which):
    store, x = make_auto_store(which, tmp_path / "s", rng, n=4000, d=48)
    assert store.get_stats()["index_type"] == "ivf"
    q = x[rng.integers(0, 4000, 20)]
    hits = total = 0
    for row in q:
        ids, _, _ = store.query(row, k=10)
        exact, _, _ = store.query(row, k=10, use_ann=False)
        hits += len(set(ids) & set(exact))
        total += 10
    assert hits / total >= 0.95, hits / total


@pytest.mark.parametrize("which", STORES)
def test_ivf_large_k_routes_to_flat(tmp_path, rng, which):
    """k > 32 on an IVF store takes the exact big-k scan."""
    x = rng.standard_normal((600, 32)).astype(np.float32)
    s = make_store(which, tmp_path / "s", dimension=32, metric="cosine",
                   enable_ann=True,
                   ann_params={"index_type": "ivf", "min_rows": 0,
                               "nprobe": 8, "n_clusters": 4,
                               "bucket_rows": 64, "self_check": False})
    s.add_vectors(x)
    calls = spy_ann(s)
    ids, scores, _ = s.query(x[3], k=40)
    assert ids[0] == 3 and len(ids) == 40
    assert calls["n"] == 0, "large-k must bypass the IVF probe path"
    ids, _, _ = s.query(x[3], k=10)
    assert calls["n"] == 1 and ids[0] == 3


@pytest.mark.parametrize("which", STORES)
def test_store_end_to_end_and_reload(tmp_path, rng, which):
    p = tmp_path / "s"
    store = make_store(which, p, dimension=32, metric="cosine",
                       enable_ann=True, persist_mode="lazy",
                       ann_params={"index_type": "ivf", "n_clusters": 16,
                                   "nprobe": 16, "self_check": False})
    x = clustered(rng, 2000, 32)
    store.add_vectors(x, [{"i": i} for i in range(2000)])
    assert store.get_stats()["index_type"] == "ivf"
    idx, scores, meta = store.query(x[7], k=3)
    assert idx[0] == 7 and scores[0] > 0.99
    idx, scores, meta = store.query(x[7], k=2, filter_metadata={"i": 7})
    assert idx == [7]
    store.flush()
    s2 = reopen(which, p)
    assert s2.get_stats()["index_type"] == "ivf"
    assert s2.query(x[3], k=1)[0][0] == 3


# ------------------------------------------- quantized stores (both stores)

ANN_PARAMS = {"auto_flat_rows": 1000, "min_rows": 0, "n_clusters": 8,
              "nprobe": 8, "bucket_rows": 512, "self_check": True}


@pytest.mark.parametrize("which", STORES)
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_auto_builds_gather_ivf_and_serves(tmp_path, rng, which, dtype):
    d = 64
    x = unit_rows(rng, 3000, d)
    store = make_store(which, tmp_path / dtype, dimension=d, metric="cosine",
                       storage_dtype=dtype, enable_ann=True,
                       ann_params=dict(ANN_PARAMS))
    store.add_vectors(x, [{"i": i} for i in range(3000)])
    assert store._ann_kind == "ivf"
    assert store._ann.get_stats()["layout"] == "gather"
    ids, scores, _ = store.query(x[42], k=5)
    assert ids[0] == 42 or scores[0] >= 0.98
    assert scores[0] > 0.9
    exact = store.batch_query(x[:8], k=5, use_ann=False)
    annr = store.batch_query(x[:8], k=5)
    for (ei, es, _), (ai, asc, _) in zip(exact, annr):
        np.testing.assert_allclose(np.asarray(asc), np.asarray(es),
                                   atol=6e-3)


@pytest.mark.parametrize("which", STORES)
def test_int8_incremental_add_and_reload(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 2500, d)
    path = tmp_path / "q_inc"
    store = make_store(which, path, dimension=d, metric="cosine",
                       storage_dtype="int8", enable_ann=True,
                       ann_params=dict(ANN_PARAMS))
    store.add_vectors(x[:2000], [{} for _ in range(2000)])
    assert store._ann_kind == "ivf"
    size0 = store._ann.size
    store.add_vectors(x[2000:], [{} for _ in range(500)])
    assert store._ann.size == 2500 and size0 == 2000
    ids, scores, _ = store.query(x[2345], k=3)
    assert scores[0] > 0.9
    store.flush()
    store2 = reopen(which, path)
    assert store2._ann is not None and store2._ann.size == 2500
    ids2, scores2, _ = store2.query(x[2345], k=3)
    np.testing.assert_allclose(scores2[0], scores[0], atol=1e-3)


@pytest.mark.parametrize("which", STORES)
def test_filtered_ann_query(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 2000, d)
    store = make_store(which, tmp_path / "f", dimension=d, metric="cosine",
                       storage_dtype="int8", enable_ann=True,
                       ann_params=dict(ANN_PARAMS))
    store.add_vectors(x, [{"par": i % 2} for i in range(2000)])
    ids, scores, md = store.query(x[10], k=5, filter_metadata={"par": 0})
    assert len(ids) > 0
    assert all(m["par"] == 0 for m in md)


@pytest.mark.parametrize("which", STORES)
def test_bf16_gather_layout_knob(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 2000, d)
    store = make_store(which, tmp_path / "g", dimension=d, metric="cosine",
                       storage_dtype="bfloat16", enable_ann=True,
                       ann_params={**ANN_PARAMS, "ivf_layout": "gather"})
    store.add_vectors(x, [{} for _ in range(2000)])
    assert store._ann_kind == "ivf"
    store.query(x[99], k=5)
    assert store._ann.get_stats()["layout"] == "gather"
    exact = store.batch_query(x[:6], k=5, use_ann=False)
    annr = store.batch_query(x[:6], k=5)
    for (ei, es, _), (ai, asc, _) in zip(exact, annr):
        np.testing.assert_allclose(np.asarray(asc), np.asarray(es),
                                   atol=6e-3)


@pytest.mark.parametrize("which", STORES)
def test_bucketized_override_on_quantized_gathers(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 1500, d)
    store = make_store(which, tmp_path / "b", dimension=d, metric="cosine",
                       storage_dtype="int8", enable_ann=True,
                       ann_params={**ANN_PARAMS,
                                   "ivf_layout": "bucketized"})
    store.add_vectors(x, [{} for _ in range(1500)])
    store.query(x[3], k=3)
    assert store._ann.get_stats()["layout"] == "gather"


@pytest.mark.parametrize("which", STORES)
def test_clear_resets_recall_guard(tmp_path, rng, which):
    d = 32
    store = make_store(which, tmp_path / "guard", dimension=d,
                       metric="cosine", enable_ann=True,
                       ann_params=dict(ANN_PARAMS))
    store.add_vectors(unit_rows(rng, 1500, d))
    assert store.get_stats()["ann_recall_estimate"] is not None
    store._ann_low_recall = True
    store._ann_checked_at = 1500
    store.clear()
    assert store._ann_low_recall is False
    assert store._ann_checked_at == 0
    assert store._ann_recall_estimate is None


@pytest.mark.parametrize("which", STORES)
def test_int4_rerank_recovers_f32_ordering(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 4000, d)
    store = make_store(which, tmp_path / "rr", dimension=d, metric="cosine",
                       storage_dtype="int4", enable_ann=True,
                       ann_params={**ANN_PARAMS, "rerank_oversample": 32})
    store.add_vectors(x, [{"i": i} for i in range(4000)])
    q = unit_rows(rng, 4, d)
    gt = q @ x.T
    out = store.batch_query(q, k=5, rerank=True)
    for qi, (ids, scores, metas) in enumerate(out):
        want = np.argsort(-gt[qi])[:5]
        assert list(ids) == want.tolist(), (qi, ids, want)
        np.testing.assert_allclose(scores, gt[qi][want], atol=1e-5)
        assert [m["i"] for m in metas] == want.tolist()


@pytest.mark.parametrize("which", STORES)
def test_rerank_with_filter(tmp_path, rng, which):
    d = 64
    x = unit_rows(rng, 2000, d)
    store = make_store(which, tmp_path / "rrf", dimension=d, metric="cosine",
                       storage_dtype="int8", enable_ann=True,
                       ann_params=dict(ANN_PARAMS))
    store.add_vectors(x, [{"g": i % 2} for i in range(2000)])
    ids, scores, metas = store.query(x[8], k=5, filter_metadata={"g": 0},
                                     rerank=True)
    assert all(m["g"] == 0 for m in metas)
    assert ids[0] == 8 and scores[0] > 0.999


# ----------------------------------------------- the two stores side by side

def assert_results_match(got, want, tol):
    assert len(got) == len(want)
    for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
        ws = np.asarray(ws, np.float64)
        for r in range(len(wi)):
            near = ((r > 0 and abs(ws[r] - ws[r - 1]) <= tol) or
                    (r + 1 < len(wi) and abs(ws[r] - ws[r + 1]) <= tol))
            if not near:
                assert gi[r] == wi[r] and gm[r] == wm[r]


@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"),
                                          ("euclidean", "float32"),
                                          ("cosine", "bfloat16")])
def test_ann_store_parity(tmp_path, metric, dtype):
    """The same adds (a build, then appends with spills), deletes,
    filtered and batched queries and optimize() on both stores: the same
    index layout, recall estimate and answers."""
    rng = np.random.default_rng(3)
    d, n, n_build = 32, 4000, 3200
    # the build sees its rows centre by centre (one strided init seed in
    # each of the 16 centres: both packages train the same centroids);
    # the append draws from the same centres at random
    centres = rng.standard_normal((16, d)).astype(np.float32)
    pick = np.concatenate([np.arange(n_build) * 16 // n_build,
                           rng.integers(0, 16, n - n_build)])
    x = centres[pick] + 0.08 * rng.standard_normal((n, d)).astype(np.float32)
    cfg = dict(dimension=d, metric=metric, storage_dtype=dtype,
               enable_ann=True, persist_mode="off",
               ann_params={"auto_flat_rows": 1000, "n_clusters": 16,
                           "nprobe": 4, "bucket_rows": 128})
    js, ts = make_store("jax", tmp_path / "j", **cfg), make_store(
        "torch", tmp_path / "t", **cfg)
    meta = [{"g": i % 3} for i in range(n)]
    for s in (js, ts):
        s.add_vectors(x[:n_build], meta[:n_build])
        s.add_vectors(x[n_build:], meta[n_build:])
    assert len(ts._ann._bucket_cluster) > 16         # the append spilled
    for a, b in zip((ts._ann._ids, ts._ann._free, ts._ann._bucket_cluster),
                    (js._ann._ids, js._ann._free, js._ann._bucket_cluster)):
        np.testing.assert_array_equal(a, b)
    assert ts.get_stats() == js.get_stats()
    tol = 1e-3 if metric == "euclidean" else 1e-4
    q = x[[5, 600, 3999, 1700]] + 0.05
    assert_results_match(ts.batch_query(q, k=10), js.batch_query(q, k=10),
                         tol)
    assert_results_match(ts.batch_query(q, k=10, filter_metadata={"g": 1}),
                         js.batch_query(q, k=10, filter_metadata={"g": 1}),
                         tol)
    for s in (js, ts):
        s.delete_vectors([5, 600])
    assert_results_match(ts.batch_query(q, k=10), js.batch_query(q, k=10),
                         tol)
    for s in (js, ts):
        s.optimize()
    assert ts.get_stats() == js.get_stats()
    assert_results_match(ts.batch_query(q, k=10), js.batch_query(q, k=10),
                         tol)


@pytest.mark.parametrize("writer", STORES)
def test_sidecar_served_by_the_other_package(tmp_path, monkeypatch, writer):
    """ann_ivf.npz written by one package opens in the other, which
    serves it without a rebuild and answers as the writer did."""
    rng = np.random.default_rng(4)
    d, n = 32, 2000
    x = clustered(rng, n, d)
    path = tmp_path / "s"
    store = make_store(writer, path, dimension=d, metric="cosine",
                       enable_ann=True, persist_mode="lazy",
                       ann_params={"auto_flat_rows": 1000, "n_clusters": 16,
                                   "nprobe": 4})
    store.add_vectors(x, [{"i": i} for i in range(n)])
    store.flush()
    q = x[[1, 999, 1998]] + 0.05
    before = store.batch_query(q, k=10)

    def no_build(*a, **kw):
        raise AssertionError("the sidecar should have been served")

    monkeypatch.setattr(JaxIVF, "build", no_build)
    monkeypatch.setattr(IVFIndex, "build", no_build)
    reader = reopen("torch" if writer == "jax" else "jax", path)
    assert reader._ann is not None and not reader._ann_stale
    assert reader._ann.size == n
    assert reader.config.ann_params["nprobe"] == 4
    assert_results_match(reader.batch_query(q, k=10), before, 1e-4)


def test_ann_failure_falls_back_to_exact(tmp_path, rng):
    store, x = make_auto_store("torch", tmp_path / "s", rng, n=1200)

    def broken(*a, **kw):
        raise RuntimeError("index failure")

    store._ann.search = broken
    ids, scores, _ = store.query(x[9], k=3)
    assert ids[0] == 9 and scores[0] > 0.999
