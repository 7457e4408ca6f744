"""ShardedVectorStore on both packages: the port's over a mesh of
``make_device_mesh(devices=["cpu"] * P)`` and the JAX package's over the
conftest's 8 CPU devices run the cases of tests/test_parallel.py's
TestShardedStore, TestShardedInt4 and its int8 case; each also answers
as the unsharded store does; and stores written by either package, sharded
or not, open in the other at another P with the same answers.

Tolerances: f32 ids equal and scores within 1e-5; int8 and int4 scores
within 5e-3 of the JAX store (the port scores with its kernels' rules,
ROADMAP queue C), ids then compared by score-recall against an f32
ground truth.

The JAX store's ``_CompiledFnCache`` (tests/test_hardening.py's
TestShardedFnCacheBound) has no counterpart: nothing is compiled per
capacity or k here. ``test_capacity_growth_keeps_one_buffer_set`` checks
what stands in its place: after capacity changes, one set of shard
buffers at the live capacity.
"""

import numpy as np
import pytest
import torch

from tpu_vector_db.parallel import mesh as jmesh
from tpu_vector_db.parallel.sharded_store import (
    ShardedVectorStore as JaxShardedStore)
from tpu_vector_db.store import TPUVectorStore
from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.parallel import ShardedVectorStore, make_device_mesh
from tpu_vector_db_torch.store.config import StoreCapacityError
from tpu_vector_db_torch.store.vector_store import (MetadataColumnIndex,
                                                    _meta_hash)

torch.set_num_threads(1)

STORES = ["jax", "torch"]


def sharded(which, path, p=8, **cfg):
    if which == "jax":
        return JaxShardedStore(path, JaxConfig(**cfg),
                               mesh=jmesh.make_device_mesh(p))
    return ShardedVectorStore(path, VectorStoreConfig(**cfg),
                              mesh=make_device_mesh(devices=["cpu"] * p))


def reopen(which, path, p=None):
    """A store's files opened by a package, sharded over p or not."""
    if which == "jax":
        return (TPUVectorStore(path) if p is None else
                JaxShardedStore(path, mesh=jmesh.make_device_mesh(p)))
    return (TorchVectorStore(path, device="cpu") if p is None else
            ShardedVectorStore(path,
                               mesh=make_device_mesh(devices=["cpu"] * p)))


def same(got, want, atol=1e-5):
    for (i1, s1, m1), (i2, s2, m2) in zip(got, want):
        assert i1 == i2
        np.testing.assert_allclose(s1, s2, atol=atol)
        assert m1 == m2


@pytest.mark.parametrize("p", [2, 4, 8])
def test_store_equivalence(tmp_path, rng, p):
    """TestShardedStore::test_store_equivalence: the port's sharded store
    equals the JAX sharded store and the port's unsharded store."""
    d, n = 24, 500
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    meta = [{"i": i, "grp": i % 4} for i in range(n)]
    cfg = dict(dimension=d, block_rows=64, initial_capacity=64,
               persist_mode="off")
    jax_s = sharded("jax", tmp_path / "j", p, **cfg)
    port = sharded("torch", tmp_path / "t", p, **cfg)
    flat = TorchVectorStore(tmp_path / "f", VectorStoreConfig(**cfg),
                            device="cpu")
    for s in (jax_s, port, flat):
        s.add_vectors(vecs, meta)
    q = rng.standard_normal((6, d)).astype(np.float32)
    got = port.batch_query(q, k=7)
    same(got, jax_s.batch_query(q, k=7))
    same(got, flat.batch_query(q, k=7), atol=0)
    st = port.get_stats()
    assert st["sharded"] and st["n_devices"] == p
    assert st["rows_per_shard"] * p == st["device_capacity"]


@pytest.mark.parametrize("which", STORES)
def test_sharded_filter(tmp_path, rng, which):
    d = 16
    store = sharded(which, tmp_path / "s", dimension=d, block_rows=64,
                    initial_capacity=64, persist_mode="off")
    vecs = rng.standard_normal((300, d)).astype(np.float32)
    store.add_vectors(vecs, [{"grp": i % 3} for i in range(300)])
    idx, _, meta = store.query(vecs[0], k=5, filter_metadata={"grp": 2})
    assert len(idx) == 5
    assert all(m["grp"] == 2 for m in meta)


@pytest.mark.parametrize("which", STORES)
def test_sharded_incremental_add(tmp_path, rng, which):
    d = 16
    shard = sharded(which, tmp_path / "s", dimension=d, block_rows=64,
                    initial_capacity=64, persist_mode="off")
    all_v = []
    for _ in range(4):
        v = rng.standard_normal((200, d)).astype(np.float32)
        shard.add_vectors(v)
        all_v.append(v)
    flatv = np.concatenate(all_v)
    idx, scores, _ = shard.query(flatv[555], k=1)
    assert idx == [555] and scores[0] > 0.999
    stats = shard.get_stats()
    assert stats["sharded"] and stats["n_devices"] == 8


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_inplace_append_no_replacement(tmp_path, rng, metric, monkeypatch):
    """Adds within capacity write only the shards they touch: no
    _reset_device after the first allocation, the other shards' buffers
    untouched, and the answers those of both unsharded stores."""
    d = 16
    shard = sharded("torch", tmp_path / "ip", dimension=d, metric=metric,
                    block_rows=64, initial_capacity=64, persist_mode="off")
    resets = []
    orig = ShardedVectorStore._reset_device
    monkeypatch.setattr(
        ShardedVectorStore, "_reset_device",
        lambda self, cap: (resets.append(cap), orig(self, cap))[1])
    v0 = rng.standard_normal((64, d)).astype(np.float32)
    shard.add_vectors(v0)          # allocation: 512 rows, 64 a shard
    allocs = len(resets)
    bufs = list(shard._db)
    untouched = [b.clone() for b in bufs[4:]]
    chunks = [rng.standard_normal((40, d)).astype(np.float32)
              for _ in range(4)]
    for c in chunks:
        shard.add_vectors(c)       # rows 64..223: shards 1-3 only
    assert len(resets) == allocs, "in-capacity adds re-created the buffers"
    assert all(a is b for a, b in zip(shard._db, bufs))
    assert all(torch.equal(a, b) for a, b in zip(shard._db[4:], untouched))
    allv = np.concatenate([v0] + chunks)
    for probe in (70, 130, 223):
        idx, _, _ = shard.query(allv[probe], k=1)
        assert idx == [probe], (probe, idx)
    cfg = dict(dimension=d, metric=metric, block_rows=64,
               persist_mode="off")
    flat = TorchVectorStore(tmp_path / "flat", VectorStoreConfig(**cfg),
                            device="cpu")
    jflat = TPUVectorStore(tmp_path / "jflat", JaxConfig(**cfg))
    flat.add_vectors(allv)
    jflat.add_vectors(allv)
    q = rng.standard_normal((3, d)).astype(np.float32)
    got = shard.batch_query(q, k=5)
    same(got, flat.batch_query(q, k=5), atol=0)
    for g, w in zip(got, jflat.batch_query(q, k=5)):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)


def score_recall(ids_lists, x, q, k, tol=5e-3):
    """Share of returned ids whose f32 cosine reaches the f32 k-th."""
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = qn @ xn.T
    kth = -np.sort(-truth, axis=1)[:, k - 1]
    hits = [truth[i, ids] >= kth[i] - tol for i, ids in enumerate(ids_lists)]
    return float(np.mean(np.concatenate(hits)))


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_sharded_matches_jax(tmp_path, rng, dtype):
    """test_sharded_int8_storage and TestShardedInt4's sharded-vs-single
    case on both packages: self-queries find themselves, scores within
    5e-3 of the JAX sharded store, ids by score-recall."""
    d = 256 if dtype == "int4" else 32
    x = rng.standard_normal((500, d)).astype(np.float32)
    cfg = dict(dimension=d, metric="cosine", storage_dtype=dtype,
               persist_mode="off")
    jax_s = sharded("jax", tmp_path / "j", 8, **cfg)
    port = sharded("torch", tmp_path / "t", 4, **cfg)
    single = TorchVectorStore(tmp_path / "one", VectorStoreConfig(**cfg),
                              device="cpu")
    for s in (jax_s, port, single):
        s.add_vectors(x)
    for i in (3, 99, 250):
        ids, sc, _ = port.query(x[i], k=5)
        assert ids[0] == i and 0.97 < sc[0] <= 1.0
        jids, jsc, _ = jax_s.query(x[i], k=5)
        np.testing.assert_allclose(sc, jsc, atol=5e-3)
        assert port.query(x[i], k=5)[:2] == single.query(x[i], k=5)[:2]
    q = rng.standard_normal((8, d)).astype(np.float32)
    r_port = score_recall([r[0] for r in port.batch_query(q, k=10)], x, q,
                          10)
    r_jax = score_recall([r[0] for r in jax_s.batch_query(q, k=10)], x, q,
                         10)
    assert r_port >= r_jax - 0.05, (r_port, r_jax)


@pytest.mark.parametrize("which", STORES)
def test_sharded_int4_inplace_append_and_filter(tmp_path, rng, which):
    """TestShardedInt4's in-place append and filtered cases."""
    store = sharded(which, tmp_path / "i4a", dimension=256,
                    metric="cosine", storage_dtype="int4",
                    persist_mode="off", block_rows=64,
                    initial_capacity=4096)
    a = rng.standard_normal((300, 256)).astype(np.float32)
    b = rng.standard_normal((200, 256)).astype(np.float32)
    store.add_vectors(a, [{"par": i % 3} for i in range(300)])
    store.add_vectors(b, [{"par": 0} for _ in range(200)])
    assert store.vector_count == 500
    ids, sc, _ = store.query(b[17], k=1)
    assert ids[0] == 300 + 17 and sc[0] > 0.97
    ids, _, metas = store.query(a[12], k=4, filter_metadata={"par": 0})
    assert ids[0] == 12
    assert all(m["par"] == 0 for m in metas)


@pytest.mark.parametrize("which", STORES)
def test_sharded_delete_exact(tmp_path, rng, which):
    """Tombstones mask out of the sharded exact scan."""
    d, n = 32, 400
    x = rng.standard_normal((n, d)).astype(np.float32)
    store = sharded(which, tmp_path / "del", dimension=d, persist_mode="off")
    store.add_vectors(x, [{"i": i} for i in range(n)])
    assert store.query(x[5], k=3)[0][0] == 5
    store.delete_vectors([5])
    assert len(store) == n - 1
    ids, _, _ = store.batch_query(x[5:6], k=5, use_ann=False)[0]
    assert 5 not in ids and len(ids) == 5


def test_capacity_growth_keeps_one_buffer_set(tmp_path, rng):
    """Five capacity changes with queries at k 1, 3, 5 between them: the
    store holds one set of shard buffers, each cap/P rows."""
    store = sharded("torch", tmp_path / "s", 4, dimension=16, block_rows=8,
                    initial_capacity=8, persist_mode="off")
    caps = []
    for _ in range(5):
        store.add_vectors(rng.standard_normal(
            (store._cap + 1 if store._cap else 70, 16)).astype(np.float32))
        caps.append(store._cap)
        for k in (1, 3, 5):
            store.batch_query(rng.standard_normal((2, 16)).astype(
                np.float32), k=k)
    assert len(set(caps)) == 5
    assert len(store._db) == 4
    assert all(b.shape[0] == store._cap // 4 for b in store._db)


def test_budget_counts_colocated_shards(tmp_path, rng, monkeypatch):
    """The device budget holds every shard a device carries: four shards
    on one device need the whole capacity there."""
    cfg = dict(dimension=128, block_rows=64, initial_capacity=64,
               persist_mode="off")
    need = VectorStoreConfig(**cfg).device_bytes_for(1024)
    monkeypatch.setenv("VDB_HBM_BYTES", str(need))  # < 1024 rows usable
    store = sharded("torch", tmp_path / "b", 4, **cfg)
    with pytest.raises(StoreCapacityError):
        store.add_vectors(rng.standard_normal((1000, 128)).astype(
            np.float32))
    store.add_vectors(rng.standard_normal((100, 128)).astype(np.float32))
    assert store.vector_count == 100


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_stores_open_across_packages_and_p(tmp_path, rng, writer, reader):
    """A sharded store flushed by one package opens in the other at
    another P, and unsharded, with the same answers (filtered and with
    tombstones too)."""
    d, n = 24, 700
    x = rng.standard_normal((n, d)).astype(np.float32)
    meta = [{"g": i % 5} for i in range(n)]
    path = tmp_path / "s"
    p_w, p_r = (8, 2) if writer == "jax" else (4, 8)
    store = sharded(writer, path, p_w, dimension=d, metric="euclidean",
                    persist_mode="lazy")
    store.add_vectors(x, meta)
    store.delete_vectors([3, 50])
    q = rng.standard_normal((5, d)).astype(np.float32)
    want = store.batch_query(q, k=6)
    want_f = store.batch_query(q, k=4, filter_metadata={"g": 2})
    store.flush()
    for opened in (reopen(reader, path, p_r), reopen(reader, path)):
        assert opened.vector_count == n - 2
        same(opened.batch_query(q, k=6), want, atol=1e-4)
        same(opened.batch_query(q, k=4, filter_metadata={"g": 2}), want_f,
             atol=1e-4)


def test_metadata_hashes_once_per_value_as_per_row():
    """Config #5 adds 10M rows of metadata: each str/int/bool value of an
    add is hashed once. The columns equal a hash of every row, and values
    that compare equal across types (True and 1, 1 and 1.0, -0.0 and
    0.0) keep their own hashes."""
    values = [True, 1, 1.0, 0, False, -0.0, 0.0, "a", "1", None, [1, 2],
              {"x": 1}, 2 ** 70]
    rows = [{"v": values[i % len(values)], "g": i % 3} for i in range(200)]
    index = MetadataColumnIndex()
    index.extend(rows[:120])
    index.extend(rows[120:])
    for key in ("v", "g"):
        want = np.array([_meta_hash(r[key]) for r in rows], np.uint64)
        np.testing.assert_array_equal(index._columns[key][:200], want)
    assert len({_meta_hash(v) for v in values}) == len(values)
