"""The port's beam graph (tpu_vector_db_torch/index/beam_graph.py, and its
native builder bridge) against the JAX package's, on the same inputs made
from a seed with numpy, with ``device="cpu"``.

The JAX module reaches no Pallas kernel: its XLA functions run here on the
CPU backend, function by function beside the port's: the lax.top_k tie
order, ``_score_ids``, ``beam_search`` on one JAX-built graph,
``alpha_prune`` (and the column walk it must equal), ``_reverse_update``,
one insert and one refine step, a whole build, ``ann_graph.npz`` across
packages and the native builder. Then tests/test_ann.py's TestBeamGraph
and TestFusedBuildPaths cases against the port, their recall gates
unchanged, and card-only cases (marked ``gpu``).

Tolerances: keys within 1e-5 on f32 rows and 1e-3 on bf16 rows (f32 sums
in another order; bf16 operands are widened exactly), relative to the
key's size on euclidean keys; ids equal away from near-ties; graphs and
edge keys equal wherever the build's discrete choices (the sort orders,
the prune's comparisons) see the same keys, which at these sizes is
everywhere: the whole builds compare exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_vector_db.index import beam_graph as JB
from tpu_vector_db.index import native as jax_native

from tpu_vector_db_torch.index import beam_graph as TB
from tpu_vector_db_torch.index import native
from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex

torch.set_num_threads(1)

NEG_INF = float("-inf")
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
METRICS = ["cosine", "euclidean", "dot"]


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def prepared(rng, n, d, metric):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return unit(x) if metric == "cosine" else x


def both(arr, dtype="float32"):
    """The same host array as a JAX array and a CPU tensor, in dtype."""
    j = jnp.asarray(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def sqnorms_of(db_j, db_t):
    return (jnp.sum(db_j.astype(jnp.float32) ** 2, -1),
            torch.sum(db_t.float() ** 2, -1))


def assert_keys_ids(got, want, tol):
    """Keys within tol (x max(1, |key|)), the same -inf slots with -1 ids;
    ids equal where the neighbouring keys are more than tol apart."""
    gi, gk = (np.asarray(a) for a in got)
    wi, wk = (np.asarray(a) for a in want)
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(gk), fin)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    t = tol * np.maximum(1.0, np.abs(np.where(fin, wk, 0.0)))
    assert np.all(np.abs(np.where(fin, gk - wk, 0.0)) <= t)
    gap = np.full(wk.shape, np.inf)
    gap[:, 1:] = np.abs(np.diff(np.where(fin, wk, 0.0), axis=1))
    gap_next = np.full(wk.shape, np.inf)
    gap_next[:, :-1] = gap[:, 1:]
    clear = fin & (gap > t) & (gap_next > t)
    np.testing.assert_array_equal(gi[clear], wi[clear])


def assert_graph_equal(got, want, tol=1e-5):
    """The same (graph, edge keys): ids equal, keys within tol x max(1,
    |key|) with the same -inf slots (f32 sums in another order)."""
    gg, gk = (np.asarray(a) for a in got)
    wg, wk = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gg, wg)
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(gk), fin)
    np.testing.assert_array_less(
        np.abs(np.where(fin, gk - wk, 0.0)),
        tol * np.maximum(1.0, np.abs(np.where(fin, wk, 0.0))) + 1e-30)


def ground_truth(queries, vectors, k, metric):
    if metric == "cosine":
        scores = unit(queries) @ unit(vectors).T
        return np.argsort(-scores, axis=1)[:, :k]
    if metric == "dot_product":
        return np.argsort(-(queries @ vectors.T), axis=1)[:, :k]
    d2 = ((queries[:, None] - vectors[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1)[:, :k]


def recall_at_k(found, truth):
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(found, truth))
    return hits / truth.size


# ------------------------------------------------------------------ top-k

@pytest.mark.parametrize("shape,k", [((1, 8), 6), ((5, 40), 1),
                                     ((5, 40), 7), ((3, 40), 40)])
def test_top_k_matches_lax(shape, k):
    """Ties to the lower index, -inf slots last in index order."""
    rng = np.random.default_rng(k)
    if shape == (1, 8):
        x = np.array([[1, 3, 3, NEG_INF, 3, NEG_INF, 2, NEG_INF]],
                     np.float32)
    else:
        x = rng.integers(0, 4, shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = NEG_INF
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = TB._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------- scoring

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_score_ids(metric, dtype):
    rng = np.random.default_rng(1)
    db = prepared(rng, 300, 48, metric)
    q = prepared(rng, 7, 48, metric)
    ids = rng.integers(-1, 300, (7, 50)).astype(np.int32)
    db_j, db_t = both(db, dtype)
    sq_j, sq_t = sqnorms_of(db_j, db_t)
    want = JB._score_ids(jnp.asarray(q), db_j, jnp.asarray(ids), metric,
                         sq_j)
    got = TB._score_ids(torch.from_numpy(q), db_t, torch.from_numpy(ids),
                        metric, sq_t)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL[dtype] * max(1.0, np.abs(want).max()),
                               rtol=0)


# ----------------------------------------------------------------- search

@pytest.fixture(scope="module")
def jax_graph():
    """One graph built by the JAX package: 2000 x 32 cosine rows."""
    rng = np.random.default_rng(2)
    db = prepared(rng, 2000, 32, "cosine")
    index = JB.BeamGraphIndex(dim=32, metric="cosine", M=8,
                              ef_construction=64, batch_size=256)
    index.build(jnp.asarray(db), 2000)
    return db, index


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("ef", [16, 100])
@pytest.mark.parametrize("q_n", [1, 5, 64])
def test_beam_search_matches(jax_graph, q_n, ef, k):
    """The same graph, entries (padded with -1) and queries: the same
    beam, over all rows and over the first 1500 (count < n)."""
    db, index = jax_graph
    rng = np.random.default_rng(q_n * 1000 + ef + k)
    q = unit(rng.standard_normal((q_n, 32)).astype(np.float32))
    entries = index._entries_padded()
    assert (entries == -1).any()
    graph = index._graph[: index._cap].copy()
    for count in (2000, 1500):
        kw = dict(k=k, ef=ef, beam_width=8, iters=max(ef // 8 * 2, 8),
                  metric="cosine")
        want = JB.beam_search(jnp.asarray(q), jnp.asarray(db),
                              jnp.asarray(graph), jnp.asarray(entries),
                              np.int32(count), **kw)
        got = TB.beam_search(torch.from_numpy(q), torch.from_numpy(db),
                             torch.from_numpy(graph),
                             torch.from_numpy(entries), count, **kw)
        assert got[0].dtype == torch.int32
        assert_keys_ids(got, want, 1e-5)
        assert np.asarray(got[0]).max() < count


# ---------------------------------------------------------------- pruning

def prune_inputs(rng, metric, b=6, w=40, n=300, d=24):
    """Base rows that are not in db: a candidate equal to its base would
    make the prune's comparisons ties decided by rounding (distances of
    order 1e-7 on both sides)."""
    db = prepared(rng, n, d, metric)
    q = prepared(rng, b, d, metric)
    ids = rng.integers(0, n, (b, w)).astype(np.int32)
    ids[:, -2:] = ids[:, :2]                  # duplicates
    ids[rng.random((b, w)) < 0.1] = -1        # invalid slots
    safe = np.maximum(ids, 0)
    if metric == "euclidean":
        keys = -(((q[:, None, :] - db[safe]) ** 2).sum(-1))
    else:
        keys = np.einsum("bd,bwd->bw", q, db[safe])
    keys = np.where(ids >= 0, keys, NEG_INF).astype(np.float32)
    return db, q, ids, keys


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_alpha_prune_matches(alpha, metric, dtype):
    """Both phases, the same kept ids in the same order, keys equal."""
    rng = np.random.default_rng(3)
    db, q, ids, keys = prune_inputs(rng, metric)
    db_j, db_t = both(db, dtype)
    sq_j, sq_t = sqnorms_of(db_j, db_t)
    want = JB.alpha_prune(jnp.asarray(q), db_j, jnp.asarray(ids),
                          jnp.asarray(keys), 12, metric, sqnorms=sq_j,
                          alpha=alpha)
    got = TB.alpha_prune(torch.from_numpy(q), db_t, torch.from_numpy(ids),
                         torch.from_numpy(keys), 12, metric, sqnorms=sq_t,
                         alpha=alpha)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("metric,alpha", [
    ("cosine", 1.0), ("cosine", 1.2), ("euclidean", 1.2), ("dot", 1.5)])
def test_matches_column_walk(rng, metric, alpha):
    """tests/test_ann.py's TestAlphaPruneEquivalence against the port: the
    round-based prune keeps what the best-to-worst column walk keeps, on
    the same pairwise matrix."""
    for trial in range(5):
        b = int(rng.integers(1, 6))
        w = int(rng.integers(8, 40))
        R = int(rng.integers(2, 12))
        d = 16
        db = rng.standard_normal((200, d)).astype(np.float32)
        if metric == "cosine":
            db /= np.linalg.norm(db, axis=-1, keepdims=True)
        q = db[rng.integers(0, 200, b)]
        ids = rng.integers(0, 200, (b, w)).astype(np.int32)
        ids[:, -2:] = ids[:, :2]
        ids[rng.random((b, w)) < 0.1] = -1
        sq = (db ** 2).sum(-1)
        safe0 = np.maximum(ids, 0)
        if metric == "euclidean":
            keys = -(((q[:, None, :] - db[safe0]) ** 2).sum(-1))
        else:
            keys = np.einsum("bd,bwd->bw", q, db[safe0])
        keys = np.where(ids >= 0, keys, NEG_INF).astype(np.float32)

        out_ids, _ = TB.alpha_prune(
            torch.from_numpy(q), torch.from_numpy(db),
            torch.from_numpy(ids), torch.from_numpy(keys), R, metric,
            sqnorms=torch.from_numpy(sq), alpha=alpha)
        out = np.sort(out_ids.numpy(), axis=1)

        order = np.argsort(-keys, axis=1, kind="stable")
        s_ids = np.take_along_axis(ids, order, 1)
        s_keys = np.take_along_axis(keys, order, 1)
        safe = np.maximum(s_ids, 0)
        rows = torch.from_numpy(db[safe])
        cross = torch.bmm(rows, rows.transpose(1, 2)).numpy()
        if metric == "euclidean":
            pd_ = sq[safe][:, :, None] - 2 * cross + sq[safe][:, None, :]
            base = -s_keys
        elif metric == "cosine":
            pd_ = 1.0 - cross
            base = 1.0 - s_keys
        else:
            pd_ = -cross
            base = -s_keys
        kept = np.zeros((b, w), bool)
        valid = s_ids >= 0
        for a in ([1.0, alpha] if alpha > 1.0 else [1.0]):
            for i in range(w):
                viol = (kept & (a * pd_[:, :, i] <= base[:, i:i + 1])
                        ).any(1)
                ok = valid[:, i] & ~viol & (kept.sum(1) < R)
                kept[:, i] |= ok
        sort_key = np.where(kept, s_keys, NEG_INF)
        pos = np.argsort(-sort_key, axis=1, kind="stable")[:, :R]
        ref_keys = np.take_along_axis(sort_key, pos, 1)
        ref = np.where(ref_keys == NEG_INF, -1,
                       np.take_along_axis(s_ids, pos, 1))
        assert np.array_equal(out, np.sort(ref, axis=1)), (
            metric, alpha, trial)


# ------------------------------------------------------------ build steps

def random_graph(rng, cap, n, R):
    """A (cap, R) graph over rows [0, n): ids -1 padded, keys sorted."""
    graph = rng.integers(0, n, (cap, R)).astype(np.int32)
    keys = np.sort(rng.random((cap, R)).astype(np.float32), axis=1)[:, ::-1]
    cut = rng.integers(R // 2, R + 1, cap)
    dead = np.arange(R)[None, :] >= cut[:, None]
    graph[dead] = -1
    keys = np.where(dead, NEG_INF, keys).astype(np.float32)
    graph[n:] = -1
    keys[n:] = NEG_INF
    return graph, np.ascontiguousarray(keys)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_reverse_update_matches(metric):
    """Backlinks grouped per target, a target with more than rev_extra
    (16) backlinks keeping the first 16 in stable order, invalid edges
    dropped: the same graph and edge keys, rows written and not."""
    rng = np.random.default_rng(4)
    cap, n, R, M, b, d = 1024, 600, 8, 4, 64, 24
    db = prepared(rng, cap, d, metric)
    graph, ekeys = random_graph(rng, cap, n, R)
    ids = np.arange(n, n + b, dtype=np.int32)
    n_ids = rng.integers(0, n, (b, R)).astype(np.int32)
    n_ids[:24, 1] = 7                         # 24 backlinks to row 7
    n_ids[rng.random((b, R)) < 0.15] = -1     # invalid edges
    n_keys = -np.sort(rng.random((b, R)).astype(np.float32), axis=1)
    n_keys = np.where(n_ids >= 0, n_keys, NEG_INF).astype(np.float32)
    db_j, db_t = both(db)
    sq_j, sq_t = sqnorms_of(db_j, db_t)
    kw = dict(M=M, R=R, metric=metric, alpha=1.2, rev_extra=16,
              rev_chunk=TB._chunk_for(b * M, 128))
    assert kw["rev_chunk"] < b * M            # several chunks
    want = JB._reverse_update(jnp.asarray(graph), jnp.asarray(ekeys), db_j,
                              jnp.asarray(ids), jnp.asarray(n_ids),
                              jnp.asarray(n_keys), sq_j, **kw)
    got = TB._reverse_update(torch.from_numpy(graph.copy()),
                             torch.from_numpy(ekeys.copy()), db_t,
                             torch.from_numpy(ids), torch.from_numpy(n_ids),
                             torch.from_numpy(n_keys), sq_t, **kw)
    assert_graph_equal(got, want)
    assert not np.array_equal(got[0].numpy()[7], graph[7])


def test_reverse_update_no_valid_edge():
    """Every forward edge invalid: nothing is written (the pad rows'
    writes are dropped in JAX, rewritten with their own rows here)."""
    rng = np.random.default_rng(5)
    graph, ekeys = random_graph(rng, 256, 200, 8)
    db = prepared(rng, 256, 16, "cosine")
    n_ids = np.full((32, 8), -1, np.int32)
    n_keys = np.full((32, 8), NEG_INF, np.float32)
    got = TB._reverse_update(
        torch.from_numpy(graph.copy()), torch.from_numpy(ekeys.copy()),
        torch.from_numpy(db), torch.arange(200, 232, dtype=torch.int32),
        torch.from_numpy(n_ids), torch.from_numpy(n_keys), None, M=4, R=8,
        metric="cosine", alpha=1.2, rev_extra=16, rev_chunk=128)
    np.testing.assert_array_equal(got[0].numpy(), graph)
    np.testing.assert_array_equal(got[1].numpy(), ekeys)


@pytest.mark.parametrize("mode", ["insert", "refine"])
def test_insert_and_refine_step_match(mode):
    """One insert batch (rows 512..575 against the first 512) and one
    refine batch (rows 64..127, exclude_self, over all 576 rows) from one
    JAX-built state: the same graph and edge keys."""
    rng = np.random.default_rng(6)
    d, n0, b = 24, 512, 64
    db = prepared(rng, 1024, d, "euclidean")
    jidx = JB.BeamGraphIndex(dim=d, metric="euclidean", M=8,
                             ef_construction=48, batch_size=256)
    db_j, db_t = both(db)
    sq_j, sq_t = sqnorms_of(db_j, db_t)
    jidx.build(db_j, n0, sqnorms=sq_j)
    graph, ekeys = jidx._graph.copy(), jidx._edge_keys.copy()
    entries = jidx._entries_padded()
    insert = mode == "insert"
    start, count0 = (n0, 0) if insert else (64, n0 + b)
    kw = dict(B=b, R=16, M=8, efc=48, iters=12, metric="euclidean",
              alpha=1.2, exclude_self=not insert, rev_extra=16,
              rev_chunk=TB._chunk_for(b * 8), insert_mode=insert, bw=4)
    want = JB._device_insert_scan(
        jnp.asarray(graph), jnp.asarray(ekeys), db_j,
        jnp.asarray([start], jnp.int32), np.int32(count0),
        jnp.asarray(entries), sq_j, **kw)
    got = TB._insert_step(
        torch.from_numpy(graph.copy()), torch.from_numpy(ekeys.copy()),
        db_t, start, count0, torch.from_numpy(entries), sq_t, **kw)
    assert_graph_equal(got, want)


# ------------------------------------------------------------ whole build

@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_build_matches_jax(metric):
    """A whole build at 3000 x 32 (bootstrap, ramp, K-batch dispatches,
    power-of-two tail, refine with its overlap window): the same graph,
    edge keys and entries, and the same recall (>= 0.9)."""
    rng = np.random.default_rng(7)
    n, d = 3000, 32
    db = prepared(rng, n, d, metric)
    db_j, db_t = both(db)
    sq_j, sq_t = sqnorms_of(db_j, db_t)
    if metric != "euclidean":
        sq_j = sq_t = None
    kw = dict(dim=d, metric=metric, M=16, ef_construction=100,
              batch_size=512)
    jidx = JB.BeamGraphIndex(**kw)
    jidx.build(db_j, n, sqnorms=sq_j)
    tidx = BeamGraphIndex(**kw, device="cpu")
    tidx.build(db_t, n, sqnorms=sq_t)
    assert_graph_equal((tidx._graph[:n], tidx._edge_keys[:n]),
                       (jidx._graph[:n], jidx._edge_keys[:n]))
    np.testing.assert_array_equal(tidx._entries, jidx._entries)
    q = rng.standard_normal((50, d)).astype(np.float32)
    qp = unit(q) if metric == "cosine" else q
    truth = ground_truth(q, db, 10, metric)
    r_j = recall_at_k(jidx.search(jnp.asarray(qp), db_j, n, k=10,
                                  sqnorms=sq_j)[0], truth)
    r_t = recall_at_k(tidx.search(torch.from_numpy(qp), db_t, n, k=10,
                                  sqnorms=sq_t)[0], truth)
    assert r_t >= 0.9 and r_j >= 0.9
    assert abs(r_t - r_j) <= 0.02
    assert tidx.get_stats() == {**jidx.get_stats(),
                                "build_time_s": tidx.get_stats()[
                                    "build_time_s"]}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_file_crosses_packages(tmp_path, writer):
    """ann_graph.npz written by one package opens in the other, which
    searches it as the writer does."""
    rng = np.random.default_rng(8)
    n, d = 1500, 16
    db = prepared(rng, n, d, "cosine")
    db_j, db_t = both(db)
    kw = dict(dim=d, metric="cosine", M=8, ef_construction=64,
              batch_size=512)
    jidx, tidx = JB.BeamGraphIndex(**kw), BeamGraphIndex(**kw, device="cpu")
    (jidx if writer == "jax" else tidx).build(
        db_j if writer == "jax" else db_t, n)
    (jidx if writer == "jax" else tidx).save(tmp_path)
    reader = tidx if writer == "jax" else jidx
    assert reader.load(tmp_path) and reader.size == n
    np.testing.assert_array_equal(tidx._graph[:n], jidx._graph[:n])
    np.testing.assert_array_equal(tidx._entries, jidx._entries)
    q = db[:10]
    assert_keys_ids(tidx.search(torch.from_numpy(q), db_t, n, k=5),
                    jidx.search(jnp.asarray(q), db_j, n, k=5), 1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_native_build_matches_jax(metric):
    """The port's build_cpu through its own loader gives the JAX
    build_cpu's graph, and the port searches it."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no g++ / native lib")
    rng = np.random.default_rng(9)
    n, d = 2000, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(dim=d, metric=metric, M=16, ef_construction=100)
    jidx, tidx = JB.BeamGraphIndex(**kw), BeamGraphIndex(**kw, device="cpu")
    assert jidx.build_cpu(x, n)["backend"] == "cpu-native"
    assert tidx.build_cpu(x, n)["backend"] == "cpu-native"
    np.testing.assert_array_equal(tidx._graph[:n], jidx._graph[:n])
    np.testing.assert_array_equal(tidx._edge_keys[:n], jidx._edge_keys[:n])
    np.testing.assert_array_equal(tidx._entries, jidx._entries)
    q = rng.standard_normal((30, d)).astype(np.float32)
    db = unit(x) if metric == "cosine" else x
    sq = torch.from_numpy((db ** 2).sum(-1)) if metric == "euclidean" \
        else None
    qp = unit(q) if metric == "cosine" else q
    ids, _ = tidx.search(torch.from_numpy(qp), torch.from_numpy(db), n,
                         k=10, sqnorms=sq)
    assert recall_at_k(ids, ground_truth(q, x, 10, metric)) >= 0.90


# -------------------------- tests/test_ann.py's graph cases, on the port

def t_prepare(vectors, metric):
    return torch.from_numpy(unit(vectors) if metric == "cosine"
                            else vectors.astype(np.float32))


class TestBeamGraph:
    @pytest.mark.parametrize("metric", ["cosine", "euclidean"])
    def test_recall_vs_flat(self, rng, metric):
        n, d, q_n, k = 4000, 32, 50, 10
        vectors = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q_n, d)).astype(np.float32)
        db = t_prepare(vectors, metric)
        sq = torch.sum(db ** 2, -1) if metric == "euclidean" else None
        index = BeamGraphIndex(dim=d, metric=metric, M=16,
                               ef_construction=100, batch_size=512,
                               device="cpu")
        index.build(db, n, sqnorms=sq)
        ids, _ = index.search(t_prepare(queries, metric), db, n, k=k,
                              ef_search=100, sqnorms=sq)
        r = recall_at_k(ids, ground_truth(queries, vectors, k, metric))
        assert r >= 0.90, f"recall@{k}={r:.3f} for {metric}"

    def test_higher_ef_higher_recall(self, rng):
        n, d, k = 3000, 24, 10
        vectors = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((30, d)).astype(np.float32)
        db = t_prepare(vectors, "cosine")
        index = BeamGraphIndex(dim=d, metric="cosine", M=8,
                               ef_construction=64, batch_size=512,
                               device="cpu")
        index.build(db, n)
        q = t_prepare(queries, "cosine")
        truth = ground_truth(queries, vectors, k, "cosine")
        r_low = recall_at_k(
            index.search(q, db, n, k=k, ef_search=16)[0], truth)
        r_high = recall_at_k(
            index.search(q, db, n, k=k, ef_search=128)[0], truth)
        assert r_high >= r_low
        assert r_high >= 0.9

    def test_incremental_add_recall(self, rng):
        n1, n2, d, k = 2000, 1000, 24, 10
        vectors = rng.standard_normal((n1 + n2, d)).astype(np.float32)
        queries = rng.standard_normal((30, d)).astype(np.float32)
        db = t_prepare(vectors, "cosine")
        index = BeamGraphIndex(dim=d, metric="cosine", M=16,
                               ef_construction=100, batch_size=512,
                               device="cpu")
        index.build(db, n1)
        index.add(db, n1, n1 + n2)
        assert index.size == n1 + n2
        ids, _ = index.search(t_prepare(queries, "cosine"), db, n1 + n2,
                              k=k, ef_search=100)
        truth = ground_truth(queries, vectors, k, "cosine")
        assert recall_at_k(ids, truth) >= 0.88
        new_truth = ground_truth(vectors[n1:n1 + 5], vectors, 1, "cosine")
        new_ids, _ = index.search(t_prepare(vectors[n1:n1 + 5], "cosine"),
                                  db, n1 + n2, k=1, ef_search=64)
        assert recall_at_k(new_ids, new_truth) == 1.0

    def test_small_n(self, rng):
        d = 16
        vectors = rng.standard_normal((5, d)).astype(np.float32)
        db = t_prepare(vectors, "cosine")
        index = BeamGraphIndex(dim=d, metric="cosine", M=4, device="cpu")
        index.build(db, 5)
        ids, keys = index.search(t_prepare(vectors[2:3], "cosine"),
                                 db, 5, k=3, ef_search=10)
        assert ids[0, 0] == 2
        assert keys[0, 0] > 0.999

    def test_persistence_roundtrip(self, rng, tmp_path):
        n, d = 1500, 16
        vectors = rng.standard_normal((n, d)).astype(np.float32)
        db = t_prepare(vectors, "cosine")
        index = BeamGraphIndex(dim=d, metric="cosine", M=8,
                               ef_construction=64, batch_size=512,
                               device="cpu")
        index.build(db, n)
        index.save(tmp_path)
        q = t_prepare(vectors[:10], "cosine")
        before, _ = index.search(q, db, n, k=5)
        loaded = BeamGraphIndex(dim=d, metric="cosine", M=8, device="cpu")
        assert loaded.load(tmp_path)
        assert loaded.size == n
        after, _ = loaded.search(q, db, n, k=5)
        np.testing.assert_array_equal(before, after)

    def test_stats(self, rng):
        d = 16
        vectors = rng.standard_normal((500, d)).astype(np.float32)
        index = BeamGraphIndex(dim=d, metric="cosine", M=8, batch_size=256,
                               device="cpu")
        index.build(t_prepare(vectors, "cosine"), 500)
        s = index.get_stats()
        assert s["nodes"] == 500
        assert 0 < s["avg_degree"] <= s["R"]
        assert s["build_time_s"] > 0


class TestFusedBuildPaths:
    def test_host_mirror_matches_device(self, rng):
        n, d = 500, 16
        db = t_prepare(rng.standard_normal((n, d)).astype(np.float32),
                       "cosine")
        idx = BeamGraphIndex(dim=d, metric="cosine", M=4,
                             ef_construction=32, batch_size=64,
                             device="cpu")
        idx.build(db, n)
        assert (idx._graph_dev.numpy() == idx._graph).all()
        assert np.array_equal(idx._ekeys_dev.numpy(), idx._edge_keys,
                              equal_nan=True)
        # the mirror is a copy, not a view of the device graph
        assert not np.shares_memory(idx._graph, idx._graph_dev.numpy())

    @pytest.mark.parametrize("n", [33, 40, 95, 257, 300])
    def test_odd_sizes_connected(self, rng, n):
        d = 16
        db = t_prepare(rng.standard_normal((max(n, 64), d))
                       .astype(np.float32), "cosine")
        idx = BeamGraphIndex(dim=d, metric="cosine", M=4,
                             ef_construction=32, batch_size=64,
                             device="cpu")
        idx.build(db, n)
        assert idx.size == n
        g = idx._graph[:n]
        assert (g >= 0).any(axis=1).all(), "every node needs an edge"
        assert (g < n).all(), "no edge may point past the built range"
        ids, _ = idx.search(db[:n], db, n, k=1, ef_search=32)
        assert (ids[:, 0] >= 0).all()

    def test_entry_cap_widens_large_store_routing(self):
        idx = BeamGraphIndex(dim=16, metric="cosine", M=4,
                             ef_construction=32, entry_cap=8192,
                             device="cpu")
        idx._n = 1 << 20
        assert idx._entry_target() == 8192
        assert idx._entry_pad() == 8192
        idx._n = 1000
        assert idx._entry_pad() == 1024
        default = BeamGraphIndex(dim=16, metric="cosine", M=4,
                                 ef_construction=32, device="cpu")
        default._n = 1 << 20
        assert default._entry_target() == 4096
        floor = BeamGraphIndex(dim=16, metric="cosine", M=4,
                               ef_construction=32, entry_cap=17,
                               device="cpu")
        assert floor.entry_cap == 1024

    def test_add_after_reload_keeps_graph(self, rng, tmp_path):
        n, d = 300, 16
        x = rng.standard_normal((n + 64, d)).astype(np.float32)
        db = t_prepare(x, "cosine")
        idx = BeamGraphIndex(dim=d, metric="cosine", M=4,
                             ef_construction=32, batch_size=64,
                             device="cpu")
        idx.build(db, n)
        idx.save(tmp_path)
        idx2 = BeamGraphIndex(dim=d, metric="cosine", M=4,
                              ef_construction=32, batch_size=64,
                              device="cpu")
        assert idx2.load(tmp_path)
        idx2.add(db, n, n + 64)
        assert idx2.size == n + 64
        st = idx2.get_stats()
        assert st["nodes"] == n + 64 and st["avg_degree"] > 0
        ids, _ = idx2.search(db[n: n + 8], db, n + 64, k=1, ef_search=32)
        assert (ids[:, 0] >= 0).all()


# ------------------------------------------------------------- card only

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q_n", [1, 8, 64])
def test_beam_search_on_card_matches_cpu(card, jax_graph, q_n):
    """One graph, searched on the card and by the CPU port: the same
    beam (f32 products without TF32)."""
    db, index = jax_graph
    rng = np.random.default_rng(q_n)
    q = unit(rng.standard_normal((q_n, 32)).astype(np.float32))
    graph = index._graph[: index._cap].copy()
    entries = index._entries_padded()
    kw = dict(k=10, ef=100, beam_width=8, iters=24, metric="cosine")
    want = TB.beam_search(torch.from_numpy(q), torch.from_numpy(db),
                          torch.from_numpy(graph),
                          torch.from_numpy(entries), 2000, **kw)
    got = TB.beam_search(torch.from_numpy(q).to(card),
                         torch.from_numpy(db).to(card),
                         torch.from_numpy(graph).to(card),
                         torch.from_numpy(entries).to(card), 2000, **kw)
    assert_keys_ids(tuple(t.cpu() for t in got), want, 1e-5)


@pytest.mark.gpu
def test_card_build_recall(card, rng):
    """A build on the card: its graph stays on the card, and recall@10
    clears test_recall_vs_flat's gate."""
    n, d, k = 4000, 32, 10
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((50, d)).astype(np.float32)
    db = t_prepare(vectors, "cosine").to(card)
    index = BeamGraphIndex(dim=d, metric="cosine", M=16,
                           ef_construction=100, batch_size=512, device=card)
    index.build(db, n)
    assert index._graph_dev.device.type == "cuda"
    ids, _ = index.search(t_prepare(queries, "cosine").to(card), db, n, k=k)
    assert recall_at_k(ids, ground_truth(queries, vectors, k,
                                         "cosine")) >= 0.90


@pytest.mark.gpu
def test_insert_loop_never_syncs_on_card(card, rng):
    """An incremental add on the card reads nothing back on the host: no
    synchronizing CUDA call between its first launch and the end (the
    entries go up from pinned memory)."""
    n0, n, d = 1100, 2000, 32
    db = t_prepare(rng.standard_normal((n, d)).astype(np.float32),
                   "cosine").to(card)
    index = BeamGraphIndex(dim=d, metric="cosine", M=8, ef_construction=64,
                           batch_size=256, device=card)
    index.build(db, n0)
    assert index._cap >= n               # no regrow (a regrow copies back)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        index.add(db, n0, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ids, _ = index.search(db[n0:n0 + 8], db, n, k=1)
    assert list(ids[:, 0]) == list(range(n0, n0 + 8))
