"""The sharded ANN indexes on both packages: ShardedIVF (a quantizer a
shard; bucket mode and the int8/int4 gather mode) and ShardedBeamGraph (a
native subgraph a shard), the port's over ``make_device_mesh(devices=
["cpu"] * P)``, the JAX package's over the conftest's 8 CPU devices.

The cases of tests/test_parallel.py's TestShardedIVF, TestShardedANN,
TestShardedAnnPersistence and its spill, reload-then-extend and delete
cases, and tests/test_quant_ivf.py's sharded cases (:219, :289, :346),
plus: a full probe equal to the JAX index's and to the sharded flat scan
at P = 2, 4 and 8; the port's subgraphs equal to the JAX package's; and
both sidecars (``ann_sharded_ivf.npz``, ``ann_sharded_graph.npz``)
written by one package and served by the other.

Tolerances: f32 ids equal and keys within 1e-5 (euclidean: times |q|^2,
the size of the f32 terms its key is the difference of); 6e-3 between an
ANN and an exact answer on an int8/int4 store (tests/test_quant_ivf.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vector_db.index import native as jax_native
from tpu_vector_db.ops import distance as JD
from tpu_vector_db.parallel import mesh as jmesh
from tpu_vector_db.parallel.sharded_ann import (
    ShardedBeamGraph as JaxShardedGraph)
from tpu_vector_db.parallel.sharded_ivf import ShardedIVF as JaxShardedIVF
from tpu_vector_db.parallel.sharded_store import (
    ShardedVectorStore as JaxShardedStore)
from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.index.ivf import IVFIndex
from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.parallel import ShardedVectorStore, make_device_mesh
from tpu_vector_db_torch.parallel.mesh import shard_rows
from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
from tpu_vector_db_torch.parallel.sharded_scan import sharded_flat_topk

torch.set_num_threads(1)

IVF_PARAMS = {"min_rows": 0, "nprobe": 64, "n_clusters": 4,
              "bucket_rows": 64, "self_check": False}
GRAPH_PARAMS = {"index_type": "beam_graph", "M": 8, "ef_construction": 64,
                "ef_search": 64}


def cpu_mesh(p):
    return make_device_mesh(devices=["cpu"] * p)


def mk_data(rng, n, d, centers=16):
    mu = rng.standard_normal((centers, d)).astype(np.float32) * 3
    return (mu[rng.integers(0, centers, n)]
            + 0.2 * rng.standard_normal((n, d))).astype(np.float32)


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def sharded(which, path, p=8, **cfg):
    if which == "jax":
        return JaxShardedStore(path, JaxConfig(**cfg),
                               mesh=jmesh.make_device_mesh(p))
    return ShardedVectorStore(path, VectorStoreConfig(**cfg),
                              mesh=cpu_mesh(p))


def needs_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("no native graph builder (g++)")


def port_rows(x, cap, metric):
    """The store's prepared f32 rows in a capacity: normalized (cosine),
    padded to 128 columns, zero past the live rows."""
    t = torch.zeros((cap, x.shape[1]))
    t[: len(x)] = torch.from_numpy(x)
    if metric == "cosine":
        t[: len(x)] = D.l2_normalize(t[: len(x)])
    return D.pad_dim(t)


# ------------------------------------------------------------- sharded IVF

@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_full_probe_equals_jax_and_flat(rng, p, metric):
    """TestShardedIVF::test_full_probe_equals_flat on both packages: every
    bucket probed, the port's ids equal the JAX index's and the sharded
    flat scan's."""
    n, d, k, cap = 600, 24, 10, 1024
    x = mk_data(rng, n, d)
    jivf = JaxShardedIVF(dim=d, metric=metric,
                         mesh=jmesh.make_device_mesh(p), nprobe=512,
                         n_clusters=4, bucket_rows=64,
                         storage_dtype=jnp.float32)
    jivf.build(x, n, cap)
    q = x[:7] / np.linalg.norm(x[:7], axis=1, keepdims=True) \
        if metric == "cosine" else x[:7] + 0.1
    jfn = jivf.make_search_fn(k, nprobe=jivf._nb_pad,
                              with_sqnorms=metric == "euclidean")
    jkeys, jids = (np.asarray(a) for a in jfn(
        jnp.asarray(JD.pad_dim(jnp.asarray(q))), *jivf.search_args()))

    mesh = cpu_mesh(p)
    rows = port_rows(x, cap, metric)
    shards = shard_rows(mesh, rows)
    sq = None
    if metric == "euclidean":
        full = torch.zeros(cap)
        full[:n] = torch.from_numpy((x ** 2).sum(-1))
        sq = shard_rows(mesh, full)
    ivf = ShardedIVF(dim=d, metric=metric, mesh=mesh, nprobe=512,
                     n_clusters=4, bucket_rows=64)
    info = ivf.build(shards, n, sqnorms=sq)
    assert info["shards"] == p and ivf.quant is None
    qt = D.pad_dim(torch.from_numpy(q))
    keys, ids = ivf.search(qt, k, nprobe=ivf.n_buckets)
    np.testing.assert_array_equal(ids.numpy(), jids)
    # euclidean keys are 2 q.x - |x|^2 - |q|^2: f32 rounding of terms of
    # size |q|^2 (~200 here), so the 1e-5 scales with it
    scale = max(1.0, float((q ** 2).sum(-1).max())) \
        if metric == "euclidean" else 1.0
    np.testing.assert_allclose(keys.numpy(), jkeys, atol=1e-5 * scale,
                               rtol=0)
    fk, fi = sharded_flat_topk(qt, shards, n, k, metric, db_sqnorms=sq)
    np.testing.assert_array_equal(ids.numpy(), fi.numpy())
    np.testing.assert_array_equal(keys.numpy(), fk.numpy())


def test_spill_buckets_searchable(rng):
    """Adds that spill into new buckets are probe-visible (the shard's
    device mirror is gathered again when its bucket count grows)."""
    d = 16
    base = rng.standard_normal((1, d)).astype(np.float32) * 3
    x = base + 0.05 * rng.standard_normal((96, d)).astype(np.float32)
    extra = base + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    host = np.concatenate([x, extra])
    mesh = cpu_mesh(8)
    rows = port_rows(host, 1024, "cosine")   # 128 rows a shard
    shards = shard_rows(mesh, rows)
    ivf = ShardedIVF(dim=d, metric="cosine", mesh=mesh, nprobe=4,
                     n_clusters=1, bucket_rows=32)
    ivf.build(shards, 96)
    assert ivf.n_buckets == 3                # 96 rows fill 3 buckets
    r = ivf.add(shards, 96, 128)  # inside shard 0: spills into a 4th
    assert r["trained"] == [] and ivf.n_buckets == 4
    assert ivf._subs[0]._dev["ids"].shape[0] == 4
    _, gids = ivf.search(rows[96:104], 10, nprobe=ivf.n_buckets)
    found = set(gids.numpy().ravel().tolist())
    assert any(g in found for g in range(96, 128))
    # a row landing in shard 1 brings it alive: its quantizer trains
    assert ivf.add(shards, 128, 129)["trained"] == [1]


def test_shard_alive_at_add_sizes_its_quantizer(rng):
    """A shard empty at build and filled by an add trains as many
    clusters as its rows call for (the JAX module keeps the one cluster
    it gave the empty shard), so its rows stay findable at a small
    nprobe."""
    d, cap, p = 16, 4096, 2
    x = mk_data(rng, 2400, d, centers=64)
    mesh = cpu_mesh(p)
    rows = port_rows(x, cap, "cosine")
    shards = shard_rows(mesh, rows)
    ivf = ShardedIVF(dim=d, metric="cosine", mesh=mesh, nprobe=4)
    ivf.build(shards, 1500)                   # shard 1 (rows 2048+) empty
    assert not ivf._subs[1].built
    assert ivf.add(shards, 1500, 2400)["trained"] == [1]
    assert len(ivf._subs[1]._centroids) == IVFIndex.auto_clusters(352)
    q = rows[2100:2164]
    _, ids = ivf.search(q, 1)
    assert (ids[:, 0].numpy() == np.arange(2100, 2164)).mean() >= 0.95
    jivf = JaxShardedIVF(dim=d, metric="cosine",
                         mesh=jmesh.make_device_mesh(p), nprobe=4,
                         storage_dtype=jnp.float32)
    jivf.build(x[:1500], 1500, cap)
    jivf.add(x, 1500, 2400)
    assert len(jivf._subs[1]._centroids) == 1   # the reference's quirk


def test_auto_kind_agrees_with_built_index(tmp_path, rng):
    d = 24
    store = sharded("torch", tmp_path / "sauto", dimension=d,
                    metric="cosine", enable_ann=True, ann_params=IVF_PARAMS)
    store.add_vectors(mk_data(rng, 300, d))
    assert isinstance(store._ann, ShardedIVF)
    assert store._ann_kind == "ivf"
    assert store.get_stats()["index_type"] == "ivf"


@pytest.mark.parametrize("p", [2, 8])
def test_store_integration_and_incremental(tmp_path, rng, p):
    """TestShardedIVF::test_store_integration_and_incremental, and the
    same answers as the JAX sharded store (every bucket probed)."""
    n, d = 500, 24
    x = mk_data(rng, n, d)
    cfg = dict(dimension=d, metric="cosine", enable_ann=True,
               ann_params={"index_type": "ivf", **IVF_PARAMS})
    store = sharded("torch", tmp_path / "sivf", p, **cfg)
    jstore = sharded("jax", tmp_path / "jivf", p, **cfg)
    store.add_vectors(x[:400])
    jstore.add_vectors(x[:400])
    assert isinstance(store._ann, ShardedIVF)
    ids, scores, _ = store.query(x[5], k=3)
    assert ids[0] == 5 and scores[0] > 0.99
    ivf, subs = store._ann, store._ann._subs
    store.add_vectors(x[400:])
    jstore.add_vectors(x[400:])
    assert store._ann is ivf and store._ann._subs is subs
    assert store._ann.size == n
    assert 450 in store.query(x[450], k=3)[0]
    q = x[:6] + 0.3 * rng.standard_normal((6, d)).astype(np.float32)
    for got, want in zip(store.batch_query(q, k=5),
                         jstore.batch_query(q, k=5)):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_sharded_quantized_gather_ivf(tmp_path, rng, dtype):
    """test_quant_ivf.py's sharded gather-mode case: a full probe matches
    the exact sharded sweep; adds extend; filters post-filter."""
    d, n = 64, 600
    x = unit_rows(rng, n, d)
    store = sharded("torch", tmp_path / f"q_{dtype}", dimension=d,
                    metric="cosine", storage_dtype=dtype, enable_ann=True,
                    ann_params={**IVF_PARAMS, "n_clusters": 2})
    store.add_vectors(x, [{"g": i % 2} for i in range(n)])
    assert isinstance(store._ann, ShardedIVF)
    assert store._ann.quant == dtype
    assert all("buckets" not in sub._dev
               for sub in store._ann._subs if sub.built)
    assert store._ann_kind == "ivf"
    exact = store.batch_query(x[:6], k=5, use_ann=False)
    annr = store.batch_query(x[:6], k=5)
    for (_, es, _), (_, asc, _) in zip(exact, annr):
        np.testing.assert_allclose(np.asarray(asc), np.asarray(es),
                                   atol=6e-3)
    more = unit_rows(rng, 40, d)
    store.add_vectors(more, [{"g": 0} for _ in range(40)])
    ids, scores, _ = store.query(more[7], k=3)
    assert ids[0] == n + 7 and scores[0] > 0.95
    ids, _, md = store.query(x[4], k=3, filter_metadata={"g": 0})
    assert md and all(m["g"] == 0 for m in md)


def test_sharded_quant_reload_skips_rebuild(tmp_path, rng):
    d, n = 64, 500
    x = unit_rows(rng, n, d)
    path = tmp_path / "q_reload"
    store = sharded("torch", path, dimension=d, metric="cosine",
                    storage_dtype="int8", enable_ann=True,
                    ann_params={**IVF_PARAMS, "n_clusters": 2})
    store.add_vectors(x)
    want = store.query(x[17], k=3)
    store.flush()
    store2 = ShardedVectorStore(path, mesh=cpu_mesh(8))
    assert isinstance(store2._ann, ShardedIVF)
    assert store2._ann.quant == "int8" and store2._ann.build_time_s == 0.0
    assert store2._ann.size == n
    got = store2.query(x[17], k=3)
    assert got[0][0] == want[0][0]
    np.testing.assert_allclose(got[1][0], want[1][0], atol=1e-3)


def test_single_device_ivf_sidecar_not_loaded_by_sharded(tmp_path, rng):
    """A single-device store's directory reopened sharded builds the
    sharded index, not the single-device ann_ivf.npz."""
    d = 32
    path = tmp_path / "migrate"
    x = unit_rows(rng, 1500, d)
    single = TorchVectorStore(path, VectorStoreConfig(
        dimension=d, metric="cosine", enable_ann=True,
        ann_params={"auto_flat_rows": 1000, "n_clusters": 16, "nprobe": 16,
                    "self_check": False}), device="cpu")
    single.add_vectors(x)
    assert single._ann_kind == "ivf"
    single.flush()
    assert (path / "ann_ivf.npz").exists()
    store = ShardedVectorStore(path, mesh=cpu_mesh(8))
    assert isinstance(store._ann, ShardedIVF)
    ids, scores, _ = store.query(x[9], k=3)
    assert ids[0] == 9 and scores[0] > 0.98


def test_sharded_delete_vectors(tmp_path, rng):
    """Tombstones post-filter out of the sharded IVF's answers and mask
    out of the exact scan."""
    d, n = 32, 400
    x = unit_rows(rng, n, d)
    store = sharded("torch", tmp_path / "sdel", dimension=d,
                    metric="cosine", enable_ann=True,
                    ann_params={**IVF_PARAMS, "n_clusters": 2})
    store.add_vectors(x, [{"i": i} for i in range(n)])
    assert store.query(x[5], k=3)[0][0] == 5
    store.delete_vectors([5])
    ids, _, _ = store.query(x[5], k=5)
    assert 5 not in ids and len(ids) == 5
    ids, _, _ = store.batch_query(x[5:6], k=5, use_ann=False)[0]
    assert 5 not in ids


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_ivf_sidecar_across_packages(tmp_path, rng, writer, reader):
    """ann_sharded_ivf.npz written by one package is served by the other
    at the same P without a rebuild; at another P it is rebuilt. Both
    answer a full probe like the writer."""
    n, d = 500, 24
    x = mk_data(rng, n, d)
    path = tmp_path / "side"
    cfg = dict(dimension=d, metric="cosine", enable_ann=True,
               persist_mode="lazy",
               ann_params={"index_type": "ivf", **IVF_PARAMS})
    store = sharded(writer, path, 4, **cfg)
    store.add_vectors(x)
    q = x[:5] + 0.3 * rng.standard_normal((5, d)).astype(np.float32)
    want = store.batch_query(q, k=5)
    store.flush()
    assert (path / "ann_sharded_ivf.npz").exists()
    for p, rebuilt in ((4, False), (2, True)):
        opened = (JaxShardedStore(path, mesh=jmesh.make_device_mesh(p))
                  if reader == "jax" else
                  ShardedVectorStore(path, mesh=cpu_mesh(p)))
        assert (opened._ann.build_time_s > 0.0) == rebuilt
        assert opened._ann.size == n
        for got, exp in zip(opened.batch_query(q, k=5), want):
            assert got[0] == exp[0]
            np.testing.assert_allclose(got[1], exp[1], atol=1e-5)


# -------------------------------------------------------- sharded graph

def test_subgraphs_equal_jax(rng):
    """ShardedBeamGraph.build (the native builder a shard) gives the JAX
    package's graphs, edge keys and entries; extends alike too."""
    needs_native()
    d, n, cap, p = 16, 900, 1024, 4
    x = rng.standard_normal((n, d)).astype(np.float32)
    jg = JaxShardedGraph(dim=d, metric="cosine",
                         mesh=jmesh.make_device_mesh(p), M=8,
                         ef_construction=64)
    pg = ShardedBeamGraph(dim=d, metric="cosine", mesh=cpu_mesh(p), M=8,
                          ef_construction=64)
    jg.build(x[:700], 700, cap)
    pg.build(x[:700], 700, cap)
    jg.add(x, 700, n)
    pg.add(x, 700, n)
    np.testing.assert_array_equal(pg._graphs_host, jg._graphs_host)
    np.testing.assert_allclose(pg._keys_host, jg._keys_host, atol=1e-6)
    for a, b in zip(pg._entry_lists, jg._entry_lists):
        np.testing.assert_array_equal(a, b)
    for s in range(p):
        np.testing.assert_array_equal(pg._graph_dev[s].numpy(),
                                      pg._graphs_host[s * 256:(s + 1) * 256])


def test_sharded_ann_recall_and_merge(tmp_path, rng):
    needs_native()
    d, n = 32, 4000
    centers = rng.standard_normal((50, d)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 50, n)] +
            rng.standard_normal((n, d))).astype(np.float32)
    cfg = dict(dimension=d, block_rows=128, initial_capacity=128,
               persist_mode="off", enable_ann=True, ann_params=GRAPH_PARAMS)
    store = sharded("torch", tmp_path / "sann", **cfg)
    jstore = sharded("jax", tmp_path / "jann", **cfg)
    meta = [{"g": i % 3} for i in range(n)]
    store.add_vectors(vecs, meta)
    jstore.add_vectors(vecs, meta)
    assert isinstance(store._ann, ShardedBeamGraph) and store._ann.built
    queries = (centers[rng.integers(0, 50, 20)] +
               rng.standard_normal((20, d))).astype(np.float32)
    hits = total = 0
    for q in queries:
        ann_ids, ann_scores, _ = store.query(q, k=5)
        exact_ids, _, _ = store.query(q, k=5, use_ann=False)
        hits += len(set(ann_ids) & set(exact_ids))
        total += len(exact_ids)
        assert len(ann_ids) == 5
        assert all(ann_scores[i] >= ann_scores[i + 1]
                   for i in range(len(ann_scores) - 1))
    assert hits / total >= 0.9, f"sharded ANN recall {hits / total:.3f}"
    # the same subgraphs searched by both packages answer alike
    for got, want in zip(store.batch_query(queries, k=5),
                         jstore.batch_query(queries, k=5)):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    idx, _, meta = store.query(queries[0], k=5, filter_metadata={"g": 1})
    assert all(m["g"] == 1 for m in meta)


def test_sharded_ann_self_query(tmp_path, rng):
    needs_native()
    d = 16
    store = sharded("torch", tmp_path / "s2", dimension=d, block_rows=64,
                    initial_capacity=64, persist_mode="off",
                    enable_ann=True, ann_params=GRAPH_PARAMS)
    vecs = rng.standard_normal((900, d)).astype(np.float32)
    store.add_vectors(vecs)
    for probe in (3, 450, 890):
        idx, scores, _ = store.query(vecs[probe], k=1)
        assert idx == [probe] and scores[0] > 0.999


def test_sharded_ann_incremental_extend(tmp_path, rng, monkeypatch):
    """In-capacity adds extend the subgraphs, never rebuild them."""
    needs_native()
    d = 16
    store = sharded("torch", tmp_path / "inc", dimension=d, block_rows=64,
                    initial_capacity=64, persist_mode="off",
                    enable_ann=True,
                    ann_params={**GRAPH_PARAMS, "self_check": False})
    builds, adds = [], []
    orig_build, orig_add = ShardedBeamGraph.build, ShardedBeamGraph.add
    monkeypatch.setattr(ShardedBeamGraph, "build", lambda self, *a, **k: (
        builds.append(1), orig_build(self, *a, **k))[1])
    monkeypatch.setattr(ShardedBeamGraph, "add", lambda self, *a, **k: (
        adds.append(1), orig_add(self, *a, **k))[1])
    vecs = rng.standard_normal((1600, d)).astype(np.float32)
    store.add_vectors(vecs[:256])
    base_builds = len(builds)
    cap = store._cap
    added = 256
    while added + 128 <= cap:
        store.add_vectors(vecs[added: added + 128])
        added += 128
    assert len(builds) == base_builds, "in-capacity add rebuilt the ANN"
    assert len(adds) >= 1 and store._ann.size == added
    for probe in (added - 5, added - 100, 40):
        assert store.query(vecs[probe], k=1)[0] == [probe]


def test_graph_degrades_to_flat_without_native(tmp_path, rng, monkeypatch):
    """No native builder: the store serves the sharded flat scan."""
    monkeypatch.setattr(native, "available", lambda: False)
    store = sharded("torch", tmp_path / "deg", 4, dimension=16,
                    enable_ann=True, persist_mode="off",
                    ann_params=GRAPH_PARAMS)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    store.add_vectors(vecs)
    assert store._ann is None
    assert store.query(vecs[7], k=1)[0] == [7]


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_graph_sidecar_reload_and_extend(tmp_path, rng, writer, reader):
    """TestShardedAnnPersistence::test_sharded_graph_reload and
    test_sharded_graph_reload_then_extend, across the packages:
    ann_sharded_graph.npz is served without a rebuild and then extends."""
    needs_native()
    x = rng.standard_normal((500, 24)).astype(np.float32)
    cfg = dict(dimension=24, metric="cosine", enable_ann=True,
               ann_params={"min_rows": 0, "index_type": "beam_graph",
                           "M": 4, "ef_construction": 32,
                           "self_check": False})
    path = tmp_path / "pg"
    s = sharded(writer, path, **cfg)
    s.add_vectors(x[:400])
    ids0 = s.query(x[5], k=3)[0]
    s.flush()
    s2 = (JaxShardedStore(path, mesh=jmesh.make_device_mesh(8))
          if reader == "jax" else ShardedVectorStore(path, mesh=cpu_mesh(8)))
    assert s2._ann.build_time_s == 0.0, "reload must not rebuild"
    assert list(s2.query(x[5], k=3)[0]) == list(ids0)
    s2.add_vectors(x[400:])
    assert s2._ann.size == 500
    assert 450 in list(s2.query(x[450], k=3)[0])
