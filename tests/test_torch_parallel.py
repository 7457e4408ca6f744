"""The port's meshes, sharded flat scan, serving mesh and dry run against
the JAX package's ``parallel/``.

The same numpy inputs, made from a seed, go through the JAX function on
the conftest's 8 CPU devices and through the port's function on a mesh of
``make_device_mesh(devices=["cpu"] * P)`` at P = 2, 4 and 8 (the cases of
tests/test_parallel.py's TestShardedScan and TestServingMesh2D).

Tolerances: f32 ids equal and keys within 1e-5; bf16, int8 and int4 keys
within 5e-3 (the port scores with its kernels' rules, ROADMAP queue C),
their ids compared by score-recall against an f32 ground truth. The
``gpu`` cases hold co-located shards on one card against the plain
version, merge an empty shard, and check that no shard syncs the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from tpu_vector_db.ops import distance as JD
from tpu_vector_db.ops.quant4 import pack_int4 as jax_pack_int4
from tpu_vector_db.parallel import mesh as jmesh
from tpu_vector_db.parallel.sharded_scan import (
    make_serving_query_fn as jax_serving_fn,
    make_sharded_query_fn as jax_query_fn)

from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.ops.cuda_scan import flat_topk, flat_topk_plain
from tpu_vector_db_torch.ops.ivf_scan import merge_small_k_plain
from tpu_vector_db_torch.ops.quant4 import pack_int4
from tpu_vector_db_torch.parallel import make_device_mesh
from tpu_vector_db_torch.parallel import mesh as pmesh
from tpu_vector_db_torch.parallel.dryrun import dryrun_multichip
from tpu_vector_db_torch.parallel.sharded_scan import (
    gather_candidates, make_serving_query_fn, make_sharded_query_fn,
    sharded_flat_topk)

torch.set_num_threads(1)

PS = [2, 4, 8]
BLOCK = 64


def cpu_mesh(p: int):
    return make_device_mesh(devices=["cpu"] * p)


def capacity(n: int, p: int) -> int:
    unit = BLOCK * p
    return -(-n // unit) * unit


def jax_sharded(p, k, metric, q, db, n, sq=None, mask=None, scales=None):
    """The JAX sharded scan on the first p of the 8 CPU devices."""
    mesh = jmesh.make_device_mesh(p)
    row = NamedSharding(mesh, PartitionSpec("shard"))
    fn, _ = jax_query_fn(mesh, k, metric=metric, db_normalized=True,
                         with_sqnorms=sq is not None,
                         with_filter=mask is not None,
                         with_scales=scales is not None, block_rows=BLOCK)
    args = [jax.device_put(jnp.asarray(q), jmesh.replicated(mesh)),
            jax.device_put(jnp.asarray(db), jmesh.row_sharding(mesh)),
            jnp.int32(n)]
    args += [jax.device_put(jnp.asarray(a), row)
             for a in (sq, mask, scales) if a is not None]
    keys, idx = fn(*args)
    return np.asarray(keys), np.asarray(idx)


def port_sharded(p, k, metric, q, db, n, sq=None, mask=None, scales=None):
    """The port's sharded scan on a mesh of p CPU shards."""
    mesh = cpu_mesh(p)
    fn, n_dev = make_sharded_query_fn(
        mesh, k, metric=metric, with_sqnorms=sq is not None,
        with_filter=mask is not None, with_scales=scales is not None)
    assert n_dev == p
    place = (lambda a: pmesh.shard_rows(mesh, torch.from_numpy(
        np.ascontiguousarray(a))))
    args = [place(a) for a in (sq, mask, scales) if a is not None]
    keys, idx = fn(torch.from_numpy(q), place(db), n, *args)
    return keys.numpy(), idx.numpy()


def prepared(rng, n, q_n, d, p, metric):
    """f32 rows in a capacity of whole shards, normalized for cosine (both
    packages take prepared rows), queries as the port takes them."""
    cap = capacity(n, p)
    raw = np.zeros((cap, d), np.float32)
    raw[:n] = rng.standard_normal((n, d))
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    db = np.array(JD.l2_normalize(jnp.asarray(raw))) \
        if metric == "cosine" else raw
    sq = (raw ** 2).sum(-1).astype(np.float32) \
        if metric == "euclidean" else None
    qp = np.array(JD.l2_normalize(jnp.asarray(q))) \
        if metric == "cosine" else q
    return db, sq, q, qp


# ------------------------------------------------------------------ mesh

def test_mesh_devices_and_axes():
    m = make_device_mesh(devices=["cpu"] * 4)
    assert m.size == 4 and m.shape == (4,) and m.axis_names == ("shard",)
    assert m.lead == torch.device("cpu") and len(m.groups()) == 1
    assert make_device_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        make_device_mesh(5, devices=["cpu"] * 4)
    s = pmesh.make_serving_mesh(2, 3, devices=["cpu"] * 8)
    assert s.shape == (2, 3) and s.axis_names == ("replica", "shard")
    assert s.size == 6 and [len(g) for g in s.groups()] == [3, 3]
    with pytest.raises(ValueError, match="exceeds 8 devices"):
        pmesh.make_serving_mesh(3, 3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_device_mesh(devices=["meta"])


def test_mesh_needs_a_card_unless_given_devices(monkeypatch):
    """No silent CPU mesh: the default mesh is the visible CUDA cards, and
    a CUDA device that is not there raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_device_mesh(devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_serving_mesh(1, 1)


def test_shard_ranges_and_placement():
    assert [pmesh.shard_range(1024, 4, s) for s in range(4)] == [
        (0, 256), (256, 512), (512, 768), (768, 1024)]
    with pytest.raises(ValueError):
        pmesh.shard_range(1000, 3, 0)
    # config #5 at P = 4: capacity 2^24, 10M rows
    rows = (1 << 24) // 4
    assert [pmesh.local_count(10_000_000, rows, s) for s in range(4)] == [
        4194304, 4194304, 1611392, 0]
    x = torch.arange(24.0).reshape(12, 2)
    parts = pmesh.shard_rows(cpu_mesh(3), x)
    assert [tuple(p.shape) for p in parts] == [(4, 2)] * 3
    assert torch.equal(torch.cat(parts), x)
    groups = pmesh.shard_rows(
        pmesh.make_serving_mesh(2, 2, devices=["cpu"] * 4), x)
    assert len(groups) == 2 and all(torch.equal(torch.cat(g), x)
                                    for g in groups)


# ------------------------------------------------------- the sharded scan

@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_sharded_equals_jax(p, metric):
    """test_parallel.py::test_sharded_equals_flat on both packages, at
    P = 2, 4, 8; the port's result also equals its unsharded engine."""
    rng = np.random.default_rng(10 + p)
    n, d, k = 3000, 32, 10
    db, sq, q, qp = prepared(rng, n, 5, d, p, metric)
    jk, ji = jax_sharded(p, k, metric, q, db, n, sq)
    pk, pi = port_sharded(p, k, metric, qp, db, n, sq)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pk, jk, atol=1e-5, rtol=1e-6)
    fk, fi = flat_topk(torch.from_numpy(qp), torch.from_numpy(db), n, k,
                       metric, None if sq is None else torch.from_numpy(sq))
    np.testing.assert_array_equal(pi, fi.numpy())
    np.testing.assert_array_equal(pk, fk.numpy())


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("k", [7, 40])
def test_sharded_filter_and_big_k_equal_jax(p, k):
    """A filter mask split over the shards; k past the merge's 32 (the
    sort merge); count inside the last shard."""
    rng = np.random.default_rng(20 + p + k)
    n, d = 1000, 24
    db, _, q, qp = prepared(rng, n, 6, d, p, "cosine")
    db = np.array(JD.pad_dim(jnp.asarray(db)))
    q = np.array(JD.pad_dim(jnp.asarray(q)))
    qp = np.array(JD.pad_dim(jnp.asarray(qp)))
    mask = np.zeros(db.shape[0], np.float32)
    mask[:n] = rng.random(n) < 0.3
    jk, ji = jax_sharded(p, k, "cosine", q, db, n, mask=mask.astype(bool))
    pk, pi = port_sharded(p, k, "cosine", qp, db, n, mask=mask)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pk, jk, atol=1e-5)
    assert mask[pi].all()


def score_recall(ids, true_scores, k, tol=5e-3):
    """Share of returned ids whose f32 score reaches the f32 k-th."""
    kth = -np.sort(-true_scores, axis=1)[:, k - 1]
    got = np.take_along_axis(true_scores, np.maximum(ids, 0), axis=1)
    return float(np.mean(got >= kth[:, None] - tol))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_sharded_quantized_within_tolerance(p, dtype):
    """bf16 and int8 rows, int4 packed rows with their scales: keys within
    5e-3 of the JAX sharded scan (int8 keys in the store's /127 scale),
    ids by score-recall against the f32 ground truth."""
    rng = np.random.default_rng(30 + p)
    n, k = 2000, 10
    d = 256 if dtype == "int4" else 128
    db, _, q, qp = prepared(rng, n, 8, d, p, "cosine")
    truth = qp @ db[:n].T
    scales = None
    if dtype == "int4":
        jdb, jsc = jax_pack_int4(jnp.asarray(db))
        jdb, scales = np.asarray(jdb), np.asarray(jsc)
        pdb = jdb
        packed, _ = pack_int4(torch.from_numpy(db))
        np.testing.assert_array_equal(packed.numpy(), jdb)  # one quantizer
    elif dtype == "int8":
        jdb = np.clip(np.round(db * 127.0), -127, 127).astype(np.int8)
        pdb = jdb
    else:
        jdb = np.asarray(jnp.asarray(db, jnp.bfloat16))
        pdb = torch.from_numpy(db).to(torch.bfloat16)
    jk, ji = jax_sharded(p, k, "cosine", q, jdb, n, scales=scales)
    mesh = cpu_mesh(p)
    fn, _ = make_sharded_query_fn(mesh, k, with_scales=scales is not None)
    pdb = pdb if isinstance(pdb, torch.Tensor) else torch.from_numpy(pdb)
    extra = ([pmesh.shard_rows(mesh, torch.from_numpy(scales))]
             if scales is not None else [])
    pk, pi = fn(torch.from_numpy(qp), pmesh.shard_rows(mesh, pdb), n,
                *extra)
    pk, pi = pk.numpy(), pi.numpy()
    scale = 1.0 / 127.0 if dtype == "int8" else 1.0
    np.testing.assert_allclose(pk * scale, jk * scale, atol=5e-3)
    r_port = score_recall(pi, truth, k)
    r_jax = score_recall(ji, truth, k)
    assert r_port >= r_jax - 0.05 and r_port >= 0.8, (r_port, r_jax)


@pytest.mark.parametrize("p", [4, 8])
def test_serving_mesh_equals_jax(p):
    """test_parallel.py's TestServingMesh2D: 2 replica groups of p/2
    shards, 4 queries a group."""
    rng = np.random.default_rng(40 + p)
    shards, n, d, k = p // 2, 1500, 32, 5
    db, _, q, qp = prepared(rng, n, 8, d, shards, "cosine")
    mesh = jmesh.make_serving_mesh(2, shards)
    fn = jax_serving_fn(mesh, k, block_rows=BLOCK)
    jk, ji = fn(jax.device_put(jnp.asarray(q), NamedSharding(
        mesh, PartitionSpec("replica", None))),
        jax.device_put(jnp.asarray(db), NamedSharding(
            mesh, PartitionSpec("shard", None))), jnp.int32(db.shape[0]))
    pm = pmesh.make_serving_mesh(2, shards, devices=["cpu"] * p)
    pk, pi = make_serving_query_fn(pm, k)(
        torch.from_numpy(qp), pmesh.shard_rows(pm, torch.from_numpy(db)),
        db.shape[0])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        make_serving_query_fn(pm, k)(torch.from_numpy(qp[:3]),
                                     pmesh.shard_rows(pm, torch.from_numpy(
                                         db)), n)


def test_empty_shards_merge_on_cpu():
    """count < k·P with empty shards: the slots past the live rows hold
    -inf and id 0, as the unsharded engine's do, for both merges."""
    rng = np.random.default_rng(50)
    mesh = cpu_mesh(4)
    db = D.pad_dim(D.l2_normalize(torch.from_numpy(
        rng.standard_normal((256, 24)).astype(np.float32))))
    q = D.pad_dim(D.l2_normalize(torch.from_numpy(
        rng.standard_normal((3, 24)).astype(np.float32))))
    for count, k in ((25, 10), (70, 40), (0, 5)):
        got = sharded_flat_topk(q, pmesh.shard_rows(mesh, db), count, k)
        want = flat_topk(q, db, count, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_dryrun(p):
    """The port's dry run (the facts of __graft_entry__.dryrun_multichip)
    on P CPU shards."""
    dryrun_multichip(cpu_mesh(p))


# ---------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def plain_sharded(q, shards, count, k, metric="cosine", sq=None, mask=None,
                  scales=None, empty_id=0):
    """The sharded scan from plain versions: flat_topk_plain a shard and
    merge_small_k_plain (k <= 32) over the same candidates."""
    rows = shards[0].shape[0]
    keys, ids = [], []
    for s, db in enumerate(shards):
        k_s, i_s = flat_topk_plain(
            q, db, pmesh.local_count(count, rows, s), k, metric,
            sq[s] if sq else None, mask[s] if mask else None,
            scales[s] if scales else None)
        keys.append(k_s)
        ids.append(i_s)
    cand = gather_candidates(keys, ids, [s * rows for s in
                                         range(len(shards))], q.device)
    return merge_small_k_plain(*cand, k, empty_id)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("q_n", [1, 64])
def test_colocated_shards_match_plain_on_card(dtype, q_n):
    """Four shards on cuda:0 (``["cuda:0"] * 4``): the kernels' sharded
    result against the plain version on the same shards (keys within
    1e-4, ids equal), and against the unsharded kernel (equal)."""
    dev = _card()
    rng = np.random.default_rng(60 + q_n)
    n, d, k = 40_000, 128 if dtype != "int4" else 256, 10
    mesh = make_device_mesh(devices=["cuda:0"] * 4)
    rows = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((n + 960, d)).astype(np.float32)).to(dev))
    scales = None
    if dtype == "int4":
        rows, scales = pack_int4(rows)
    elif dtype == "int8":
        rows = torch.clamp(torch.round(rows * 127), -127, 127).to(torch.int8)
    else:
        rows = rows.to(getattr(torch, dtype))
    q = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((q_n, d)).astype(np.float32)).to(dev))
    mask = (torch.rand(rows.shape[0], device=dev) < 0.5).float()
    shards = pmesh.shard_rows(mesh, rows)
    sc = pmesh.shard_rows(mesh, scales) if scales is not None else None
    for m in (None, pmesh.shard_rows(mesh, mask)):
        got = sharded_flat_topk(q, shards, n, k, filter_mask=m,
                                db_scales=sc)
        want = plain_sharded(q.cpu(), [s.cpu() for s in shards], n, k,
                             mask=[x.cpu() for x in m] if m else None,
                             scales=[x.cpu() for x in sc] if sc else None)
        torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4,
                                   rtol=0)
        assert torch.equal(got[1].cpu(), want[1])
        flat = flat_topk(q, rows, n, k, filter_mask=mask if m else None,
                         db_scales=scales)
        assert torch.equal(got[1], flat[1]) and torch.equal(got[0], flat[0])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40])
def test_empty_shard_merge_on_card(k):
    """count < k·P with the last shard empty (as config #5's fourth shard
    at P = 4): equal to the unsharded kernel, -inf slots with id 0."""
    dev = _card()
    rng = np.random.default_rng(70 + k)
    mesh = make_device_mesh(devices=["cuda:0"] * 4)
    db = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((1024, 128)).astype(np.float32)).to(dev))
    q = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((5, 128)).astype(np.float32)).to(dev))
    for count in (k * 4 - 7, 3, 600):
        got = sharded_flat_topk(q, pmesh.shard_rows(mesh, db), count, k)
        want = flat_topk(q, db, count, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        if count < k:
            assert (got[1][:, count:] == 0).all()
            assert torch.isinf(got[0][:, count:]).all()


@pytest.mark.gpu
def test_no_host_sync_per_shard_on_card():
    """Four shards scanned and merged with CUDA's sync debug mode set to
    raise: no shard's scan, copy or the merge waits on the host."""
    dev = _card()
    rng = np.random.default_rng(80)
    mesh = make_device_mesh(devices=["cuda:0"] * 4)
    db = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((8192, 128)).astype(np.float32)).to(dev))
    q = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((4, 128)).astype(np.float32)).to(dev))
    shards = pmesh.shard_rows(mesh, db)
    want = sharded_flat_topk(q, shards, 7000, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sharded_flat_topk(q, shards, 7000, 10)
        big = sharded_flat_topk(q, shards, 7000, 40)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(big[1][:, :10], want[1])


@pytest.mark.gpu
def test_shards_on_distinct_cards(tmp_path):
    """One shard a visible card (skips with fewer than two cards): the
    merged result equals the unsharded kernel's on the first card, the
    winners cross the cards with no host sync, and a ShardedVectorStore
    over the cards answers as a TorchVectorStore does."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
    from tpu_vector_db_torch.parallel import ShardedVectorStore
    rng = np.random.default_rng(90)
    mesh = make_device_mesh()
    assert mesh.size == torch.cuda.device_count()
    lead = mesh.lead
    db = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((mesh.size * 8192, 128)).astype(
            np.float32)).to(lead))
    q = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((16, 128)).astype(np.float32)).to(lead))
    shards = pmesh.shard_rows(mesh, db)
    assert [s.device for s in shards] == list(mesh.devices)
    count = db.shape[0] - 5000
    for k in (10, 40):
        want = flat_topk(q, db, count, k)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = sharded_flat_topk(q, shards, count, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert got[0].device == lead
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    meta = [{"g": i % 7} for i in range(len(x))]
    cfg = dict(dimension=64, persist_mode="off")
    store = ShardedVectorStore(tmp_path / "s", VectorStoreConfig(**cfg),
                               mesh=mesh)
    flat = TorchVectorStore(tmp_path / "f", VectorStoreConfig(**cfg),
                            device=lead)
    for s in (store, flat):
        s.add_vectors(x, meta)
        s.delete_vectors([3, 9000])
    qs = rng.standard_normal((8, 64)).astype(np.float32)
    for kw in ({}, {"filter_metadata": {"g": 2}}):
        for got, exp in zip(store.batch_query(qs, k=10, **kw),
                            flat.batch_query(qs, k=10, **kw)):
            assert got[0] == exp[0]
            np.testing.assert_allclose(got[1], exp[1], atol=1e-6)
