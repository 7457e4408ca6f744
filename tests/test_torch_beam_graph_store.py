"""The beam-graph store on both packages: TorchVectorStore (device="cpu")
with ``index_type="beam_graph"`` beside TPUVectorStore.

tests/test_ann.py's store-level graph cases (TestStoreANNIntegration,
TestNativeBuilder's store case, the ann_params plumbing of
TestFusedBuildPaths) run against the port; then one sequence on both
stores from one ``ann_graph.npz`` (add, query, filtered query,
incremental add, delete, flush and reopen), the recall guard's refine
remediation, the native builder behind ``build_backend``, the graph file
served across packages, and a bf16 graph store with ``rerank`` (on the
CPU beside the JAX store, and on the card, marked ``gpu``).

Tolerances: scores within 1e-5 between the two stores on f32 rows (1e-3
on bf16 rows; euclidean distances 1e-4), ids equal away from near-ties.
"""

import shutil

import numpy as np
import pytest
import torch

from tpu_vector_db.index.beam_graph import BeamGraphIndex as JaxGraph
from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.store.vector_store import TPUVectorStore

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex

torch.set_num_threads(1)

GRAPH = {"index_type": "beam_graph", "M": 8, "ef_construction": 64,
         "ef_search": 64}


def make_store(which, path, **cfg):
    if which == "jax":
        return TPUVectorStore(path, JaxConfig(**cfg))
    return TorchVectorStore(path, VectorStoreConfig(**cfg), device="cpu")


def reopen(which, path):
    return (TPUVectorStore(path) if which == "jax"
            else TorchVectorStore(path, device="cpu"))


def graph_store(path, d=24, persist_mode="lazy", **ann):
    return make_store("torch", path, dimension=d, enable_ann=True,
                      persist_mode=persist_mode,
                      ann_params={**GRAPH, **ann})


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


# ------------------------- tests/test_ann.py's store cases, on the port

class TestStoreANNIntegration:
    def test_ann_query_path(self, tmp_store_path, rng):
        store = graph_store(tmp_store_path)
        vecs = rng.standard_normal((1200, 24)).astype(np.float32)
        store.add_vectors(vecs, [{"i": i, "g": i % 2} for i in range(1200)])
        assert store.get_stats()["index_type"] == "beam_graph"
        assert isinstance(store._ann, BeamGraphIndex)
        idx, scores, meta = store.query(vecs[77], k=5)
        assert idx[0] == 77 and scores[0] > 0.999

    def test_ann_filter_oversamples(self, tmp_store_path, rng):
        store = graph_store(tmp_store_path)
        vecs = rng.standard_normal((800, 24)).astype(np.float32)
        store.add_vectors(vecs, [{"g": i % 4} for i in range(800)])
        idx, _, meta = store.query(vecs[0], k=5, filter_metadata={"g": 1})
        assert len(idx) > 0
        assert all(m["g"] == 1 for m in meta)

    def test_ann_incremental_via_store(self, tmp_store_path, rng):
        store = graph_store(tmp_store_path)
        a = rng.standard_normal((600, 24)).astype(np.float32)
        b = rng.standard_normal((400, 24)).astype(np.float32)
        store.add_vectors(a)
        size_after_first = store._ann.size
        store.add_vectors(b)
        assert store._ann.size == 1000
        assert size_after_first == 600
        idx, scores, _ = store.query(b[17], k=1)
        assert idx == [617] and scores[0] > 0.999

    def test_ann_persistence_via_store(self, tmp_store_path, rng):
        store = graph_store(tmp_store_path)
        vecs = rng.standard_normal((700, 24)).astype(np.float32)
        store.add_vectors(vecs)
        store.flush()
        build_time = store._ann.build_time_s
        reloaded = graph_store(tmp_store_path)
        # graph loaded from disk, not rebuilt
        assert reloaded._ann.size == 700
        assert reloaded._ann.build_time_s == 0.0
        idx, _, _ = reloaded.query(vecs[3], k=1)
        assert idx == [3]
        assert build_time > 0

    def test_ann_failure_falls_back_to_flat(self, tmp_store_path, rng):
        store = graph_store(tmp_store_path)
        vecs = rng.standard_normal((300, 24)).astype(np.float32)
        store.add_vectors(vecs)
        store._ann._graph_dev = None  # sabotage -> search raises
        idx, scores, _ = store.query(vecs[9], k=3)  # falls back, still exact
        assert idx[0] == 9 and scores[0] > 0.999


def test_store_cpu_backend(tmp_store_path, rng, monkeypatch):
    """build_backend="cpu": the native builder builds the graph,
    incremental adds extend it on the store's device."""
    if not native.available():
        pytest.skip("no g++ / native lib")
    store = graph_store(tmp_store_path, persist_mode="off",
                        build_backend="cpu")
    vecs = rng.standard_normal((1500, 24)).astype(np.float32)
    stats = []
    build_cpu = BeamGraphIndex.build_cpu

    def spy(self, *a, **kw):
        stats.append(build_cpu(self, *a, **kw))
        return stats[-1]

    monkeypatch.setattr(BeamGraphIndex, "build_cpu", spy)
    store.add_vectors(vecs)
    assert [s["backend"] for s in stats] == ["cpu-native"]
    idx, scores, _ = store.query(vecs[321], k=3)
    assert idx[0] == 321 and scores[0] > 0.999
    more = rng.standard_normal((200, 24)).astype(np.float32)
    store.add_vectors(more)
    idx, _, _ = store.query(more[50], k=1)
    assert idx == [1550]


@pytest.mark.parametrize("backend", ["cpu", "auto"])
def test_backend_without_native_builds_on_device(tmp_store_path, rng,
                                                 monkeypatch, backend):
    """Without the native builder, "cpu"/"auto" build on the store's own
    device, as the JAX store falls back to its device build."""
    monkeypatch.setattr(native, "available", lambda: False)
    store = graph_store(tmp_store_path, persist_mode="off",
                        build_backend=backend)

    def refuse(*a, **kw):
        raise AssertionError("the native builder was called")

    monkeypatch.setattr(BeamGraphIndex, "build_cpu", refuse)
    vecs = rng.standard_normal((400, 24)).astype(np.float32)
    store.add_vectors(vecs)
    assert store._ann.size == 400 and store._ann.build_time_s > 0
    assert store.query(vecs[5], k=1)[0] == [5]


def test_entry_cap_plumbs_through_store(tmp_store_path, rng):
    store = make_store(
        "torch", tmp_store_path, dimension=16, persist_mode="off",
        enable_ann=True,
        ann_params={"index_type": "beam_graph", "min_rows": 0,
                    "ann_min_rows": 0, "entry_cap": 8192})
    store.add_vectors(rng.standard_normal((300, 16)).astype(np.float32))
    store.query(np.zeros(16, np.float32), k=3, use_ann=True)
    assert store._ann is not None and store._ann.entry_cap == 8192


def test_budget_divs_plumb_through_store(tmp_store_path, rng):
    store = make_store(
        "torch", tmp_store_path, dimension=16, persist_mode="off",
        enable_ann=True,
        ann_params={"index_type": "beam_graph", "min_rows": 0,
                    "ann_min_rows": 0, "insert_budget_div": 1,
                    "refine_budget_div": 1})
    store.add_vectors(rng.standard_normal((300, 16)).astype(np.float32))
    store.query(np.zeros(16, np.float32), k=3, use_ann=True)
    assert store._ann.insert_budget_div == 1
    assert store._ann.refine_budget_div == 1
    assert BeamGraphIndex(dim=16, M=4).insert_budget_div == 3
    assert BeamGraphIndex(dim=16, M=4).refine_budget_div == 2
    assert BeamGraphIndex(dim=16, M=4,
                          insert_budget_div=0).insert_budget_div == 1


# ---------------------------------------------- the two stores side by side

@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"),
                                          ("euclidean", "float32"),
                                          ("cosine", "bfloat16")])
def test_graph_store_parity(tmp_path, metric, dtype):
    """A graph built by the JAX store, opened from its files by both
    packages, then the same sequence on both: query, filtered query,
    incremental add, delete, flush and reopen. The same graph and
    answers throughout."""
    rng = np.random.default_rng(11)
    d, n, n_add = 24, 1200, 300
    x = rng.standard_normal((n + n_add, d)).astype(np.float32)
    meta = [{"g": i % 3} for i in range(n + n_add)]
    cfg = dict(dimension=d, metric=metric, storage_dtype=dtype,
               enable_ann=True, persist_mode="lazy", ann_params=dict(GRAPH))
    writer = make_store("jax", tmp_path / "w", **cfg)
    writer.add_vectors(x[:n], meta[:n])
    writer.flush()
    for which in ("jax", "torch"):
        shutil.copytree(tmp_path / "w", tmp_path / which)
    js, ts = reopen("jax", tmp_path / "jax"), reopen("torch", tmp_path /
                                                     "torch")
    assert ts._ann.build_time_s == 0.0 and ts._ann.size == n
    tol = {"bfloat16": 1e-3}.get(dtype, 1e-4 if metric == "euclidean"
                                 else 1e-5)
    q = x[[3, 500, 1100, 7]] + 0.1 * rng.standard_normal((4, d)).astype(
        np.float32)

    def same(**kw):
        assert_results_match(ts.batch_query(q, k=10, **kw),
                             js.batch_query(q, k=10, **kw), tol)

    same()
    same(filter_metadata={"g": 1})
    for s in (js, ts):
        s.add_vectors(x[n:], meta[n:])            # incremental add
    assert ts._ann.size == js._ann.size == n + n_add
    ts._ann._materialize_host()
    js._ann._materialize_host()
    np.testing.assert_array_equal(ts._ann._graph[: n + n_add],
                                  js._ann._graph[: n + n_add])
    assert ts.get_stats() == js.get_stats()
    same()
    for s in (js, ts):
        s.delete_vectors([3, 500, 1250])
    same()
    same(filter_metadata={"g": 2})
    for s in (js, ts):
        s.flush()
    js2, ts2 = reopen("jax", tmp_path / "jax"), reopen("torch", tmp_path /
                                                       "torch")
    assert ts2._ann.build_time_s == 0.0 and ts2._ann.size == n + n_add
    assert_results_match(ts2.batch_query(q, k=10), js2.batch_query(q, k=10),
                         tol)


def test_remediation_refines_the_graph(tmp_path, monkeypatch):
    """Below remediate_target the guard runs full-budget refine passes on
    both stores: the same refined graph and recall estimate."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((900, 16)).astype(np.float32)
    cfg = dict(dimension=16, enable_ann=True, persist_mode="off",
               ann_params={**GRAPH, "remediate_target": 1.01,
                           "remediate_max_refines": 1})
    js = make_store("jax", tmp_path / "j", **cfg)
    ts = make_store("torch", tmp_path / "t", **cfg)
    refines = []
    refine = BeamGraphIndex.refine

    def spy(self, *a, **kw):
        refines.append(self.refine_budget_div)
        return refine(self, *a, **kw)

    monkeypatch.setattr(BeamGraphIndex, "refine", spy)
    for s in (js, ts):
        s.add_vectors(x)
    assert refines == [2, 1]        # the build's pass, then remediation's
    ts._ann._materialize_host()
    js._ann._materialize_host()
    np.testing.assert_array_equal(ts._ann._graph[:900], js._ann._graph[:900])
    assert ts.get_stats()["ann_recall_estimate"] == \
        js.get_stats()["ann_recall_estimate"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_file_served_by_the_other_package(tmp_path, monkeypatch,
                                                writer):
    """ann_graph.npz written by one store opens in the other, which serves
    it without a build and answers as the writer did."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1000, 24)).astype(np.float32)
    path = tmp_path / "s"
    store = make_store(writer, path, dimension=24, enable_ann=True,
                       persist_mode="lazy", ann_params=dict(GRAPH))
    store.add_vectors(x, [{"i": i} for i in range(1000)])
    store.flush()
    q = x[[1, 499, 998]] + 0.05
    before = store.batch_query(q, k=10)

    def no_build(*a, **kw):
        raise AssertionError("the graph should have been served")

    monkeypatch.setattr(JaxGraph, "build", no_build)
    monkeypatch.setattr(BeamGraphIndex, "build", no_build)
    reader = reopen("torch" if writer == "jax" else "jax", path)
    assert reader._ann is not None and not reader._ann_stale
    assert reader._ann.size == 1000
    assert_results_match(reader.batch_query(q, k=10), before, 1e-5)


def test_bf16_rerank_matches_jax(tmp_path):
    """A bf16 graph store with rerank=True (k x 4 through the graph, then
    re-scored on the f32 rows): the same answers as the JAX store."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    cfg = dict(dimension=32, storage_dtype="bfloat16", enable_ann=True,
               persist_mode="off", ann_params=dict(GRAPH))
    js, ts = make_store("jax", tmp_path / "j", **cfg), make_store(
        "torch", tmp_path / "t", **cfg)
    for s in (js, ts):
        s.add_vectors(x)
    q = x[[2, 800]] + 0.05
    got, want = ts.batch_query(q, k=5, rerank=True), js.batch_query(
        q, k=5, rerank=True)
    assert_results_match(got, want, 1e-5)
    assert got[0][0][0] == 2 and got[1][0][0] == 800


# ------------------------------------------------------------- card only

@pytest.mark.gpu
def test_bf16_graph_store_rerank_on_card(tmp_path):
    """On the card: a bf16 graph store serves rerank=True through the
    graph (no flat scan launched), with the CPU port's answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    rng = np.random.default_rng(15)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    cfg = dict(dimension=64, storage_dtype="bfloat16", enable_ann=True,
               persist_mode="off", ann_params=dict(GRAPH))
    card = TorchVectorStore(tmp_path / "c", VectorStoreConfig(**cfg),
                            device="cuda")
    host = make_store("torch", tmp_path / "h", **cfg)
    for s in (card, host):
        s.add_vectors(x)
    q = x[[10, 2000, 2999]] + 0.05
    before = dict(LAUNCHES)
    got = card.batch_query(q, k=10, rerank=True)
    assert dict(LAUNCHES) == before
    assert_results_match(got, host.batch_query(q, k=10, rerank=True), 1e-5)
    assert [r[0][0] for r in got] == [10, 2000, 2999]
