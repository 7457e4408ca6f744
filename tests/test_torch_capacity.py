"""The capacity modes (int8 and int4 storage) and the blocked device
upload of TorchVectorStore.

* A store writes its host rows to the device in blocks of at most
  ``vector_store.UPLOAD_BLOCK_BYTES`` of f32. With the constant patched to
  a few rows, the device matrix, int4 scales and euclidean sqnorms are
  bit for bit those of a one-shot write, after a grow through capacity
  doublings, a reopen and a compact, on the single-device store and on
  the sharded one.
* The same add / query / rerank / filter / delete / flush / reopen
  sequence on TPUVectorStore and TorchVectorStore(device="cpu") for int8
  and int4, exact and with the gather-layout IVF, gives the same answers;
  a store written by either package opens in the other.
* ``gpu`` cases run the sequence on the card against the CPU store.

Tolerances are tests/test_torch_store.py's: int8 scores within 5e-3 (the
query's bf16 rounding), int4 within 3e-3 (the folded nibble offset),
ids equal away from near-ties; answers re-scored by ``rerank=True`` are
f32 on the host in both packages: ids equal, scores within 1e-5. Card
against CPU: scores within 1e-4 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.store.vector_store import TPUVectorStore

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.parallel import ShardedVectorStore, make_device_mesh
from tpu_vector_db_torch.store import vector_store

torch.set_num_threads(1)

D = 64
ONE_SHOT = 1 << 62          # a block larger than any store here
TOL = {"int8": 5e-3, "int4": 3e-3}


def unit_rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def clustered(rng, n, d=D, centres=16, n_build=1500):
    """Rows round 16 centres: the build's first ``n_build`` rows centre by
    centre (both packages' strided k-means seeds land one a centre), the
    appended rows from the same centres at random."""
    c = rng.standard_normal((centres, d)).astype(np.float32)
    pick = np.concatenate([np.arange(n_build) * centres // n_build,
                           rng.integers(0, centres, n - n_build)])
    return c[pick] + 0.08 * rng.standard_normal((n, d)).astype(np.float32)


def device_bytes(store) -> dict:
    """The store's device rows, int4 scales and euclidean sqnorms as raw
    bytes on the host (a sharded store's shards one after another)."""
    out = {}
    for name in ("_db", "_scales", "_sqnorms"):
        t = getattr(store, name)
        if t is None:
            out[name] = None
            continue
        parts = t if isinstance(t, list) else [t]
        out[name] = np.concatenate([
            p.detach().cpu().contiguous().view(torch.uint8).numpy().ravel()
            for p in parts])
    return out


def assert_same_bytes(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in got:
        if want[name] is None:
            assert got[name] is None, name
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


@pytest.fixture
def blocks(monkeypatch):
    """``blocks(rows, d=D)`` sets the upload block to ``rows`` rows of d
    components (None: one block for any store here) and returns the list
    that records the row count of every block written from then on."""
    seen = []
    for cls in (TorchVectorStore, ShardedVectorStore):
        def spy(self, arr, offset, _write=cls.__dict__["_write_block"]):
            seen.append(arr.shape[0])
            return _write(self, arr, offset)
        monkeypatch.setattr(cls, "_write_block", spy)

    def set_rows(rows, d=D):
        monkeypatch.setattr(vector_store, "UPLOAD_BLOCK_BYTES",
                            ONE_SHOT if rows is None else rows * 4 * d)
        seen.clear()
        return seen

    return set_rows


def test_upload_blocks_cover_rows_in_near_equal_parts(monkeypatch):
    monkeypatch.setattr(vector_store, "UPLOAD_BLOCK_BYTES", 10 * 4 * D)
    for n in (0, 1, 9, 10, 11, 25, 101):
        parts = vector_store.upload_blocks(n, D)
        sizes = [b - a for a, b in parts]
        assert sum(sizes) == n and all(0 < s <= 10 for s in sizes)
        assert [a for a, _ in parts] == ([0] + [b for _, b in parts])[:-1]
        assert not sizes or max(sizes) - min(sizes) <= 1
    monkeypatch.setattr(vector_store, "UPLOAD_BLOCK_BYTES", 1)
    assert vector_store.upload_blocks(3, D) == [(0, 1), (1, 2), (2, 3)]


BLOCK_DTYPES = [("euclidean", "float32"), ("cosine", "bfloat16"),
                ("cosine", "int8"), ("cosine", "int4")]


def _scenario(kind, path, cfg, rng_seed, make, sizes=(50, 30, 200, 333, 7)):
    """Run one scenario on a fresh store at ``path``; return the store
    whose device state is compared."""
    rng = np.random.default_rng(rng_seed)
    d = cfg["dimension"]
    if kind == "grow":
        store = make(path, VectorStoreConfig(persist_mode="off", **cfg))
        for n in sizes:                       # 64 -> 128 -> ... -> 1024
            store.add_vectors(rng.standard_normal((n, d)).astype(np.float32))
        assert store._cap == 1024 and store._count == sum(sizes)
        return store
    if kind == "compact":
        store = make(path, VectorStoreConfig(persist_mode="off", **cfg))
        store.add_vectors(rng.standard_normal((700, d)).astype(np.float32))
        store.delete_vectors(np.arange(0, 700, 7))
        assert store.compact()["compacted"] == 100
        return store
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["grow", "reopen", "compact"])
@pytest.mark.parametrize("metric,dtype", BLOCK_DTYPES)
def test_blocked_upload_is_bit_identical(tmp_path, blocks, kind, metric,
                                         dtype):
    """Blocks of 3 rows write the bytes a one-shot upload writes."""
    cfg = dict(dimension=D, metric=metric, storage_dtype=dtype,
               initial_capacity=64, block_rows=64)

    def make(path, config):
        return TorchVectorStore(path, config, device="cpu")

    if kind == "reopen":
        rng = np.random.default_rng(5)
        blocks(None)
        writer = make(tmp_path / "w", VectorStoreConfig(persist_mode="lazy",
                                                        **cfg))
        writer.add_vectors(rng.standard_normal((1024, D)).astype(np.float32))
        writer.flush()
        seen = blocks(3)
        got = make(tmp_path / "w", None)
        n_blocks = list(seen)
        blocks(None)
        want = make(tmp_path / "w", None)
        assert got._count == 1024
        np.testing.assert_array_equal(got._host_buf, writer._host_buf[:1024])
    else:
        seen = blocks(3)
        got = _scenario(kind, tmp_path / "b", cfg, 5, make)
        n_blocks = list(seen)
        blocks(None)
        want = _scenario(kind, tmp_path / "o", cfg, 5, make)
    assert len(n_blocks) > 100 and max(n_blocks) <= 3
    assert_same_bytes(device_bytes(got), device_bytes(want))
    q = np.random.default_rng(6).standard_normal((4, D)).astype(np.float32)
    assert got.batch_query(q, k=10) == want.batch_query(q, k=10)


@pytest.mark.parametrize("dtype", ["int4", "float32"])
def test_sharded_blocked_upload_is_bit_identical(tmp_path, blocks, dtype):
    """A sharded store over 4 CPU shards: blocks of 3 rows, which cross
    shard ranges, write each shard's bytes as one upload does, through a
    grow and a reopen at another P."""
    metric = "cosine" if dtype == "int4" else "euclidean"
    cfg = dict(dimension=D, metric=metric, storage_dtype=dtype,
               initial_capacity=64, block_rows=64)

    def make(path, config, p=4):
        return ShardedVectorStore(path, config,
                                  mesh=make_device_mesh(devices=["cpu"] * p))

    out = {}
    for rows, name in ((3, "b"), (None, "o")):
        seen = blocks(rows)
        store = make(tmp_path / name,
                     VectorStoreConfig(persist_mode="lazy", **cfg))
        rng = np.random.default_rng(8)
        for n in (100, 300, 411):        # 256 -> 512 -> 1024 rows
            store.add_vectors(rng.standard_normal((n, D)).astype(np.float32))
        store.flush()
        reopened = make(tmp_path / name, None, p=2)
        out[name] = (device_bytes(store), device_bytes(reopened),
                     list(seen))
    assert len(out["b"][2]) > 100 and max(out["b"][2]) <= 3
    assert_same_bytes(out["b"][0], out["o"][0])
    assert_same_bytes(out["b"][1], out["o"][1])


@pytest.mark.parametrize("count", [37, 64, 1000])
def test_reopen_adopts_the_loaded_rows(tmp_path, monkeypatch, count):
    """A reopen keeps the array it loaded as its host buffer, grown in
    place to the capacity a store never closed holds, at a row count
    below or at a capacity (no second copy of the rows); the store then
    reports, grows and answers as that store does."""
    rng = np.random.default_rng(9)
    cfg = VectorStoreConfig(dimension=D, persist_mode="lazy",
                            initial_capacity=64, block_rows=64)
    first = rng.standard_normal((count, D)).astype(np.float32)
    more = rng.standard_normal((30, D)).astype(np.float32)
    kept = TorchVectorStore(tmp_path / "kept", cfg, device="cpu")
    writer = TorchVectorStore(tmp_path / "s", cfg, device="cpu")
    for store in (kept, writer):
        store.add_vectors(first)
    writer.flush()
    loaded = []

    def spy(*args, _load=vector_store.persistence.load_store):
        out = _load(*args)
        loaded.append(out[0])
        return out

    monkeypatch.setattr(vector_store.persistence, "load_store", spy)
    store = TorchVectorStore(tmp_path / "s", device="cpu")
    assert store._host_buf is loaded[0]
    assert store._host_cap == kept._host_cap >= count
    np.testing.assert_array_equal(store._host_buf, kept._host_buf)
    assert store.get_stats() == kept.get_stats()
    for s in (kept, store):
        s.add_vectors(more)
    assert store._host_cap == kept._host_cap >= count + 30
    np.testing.assert_array_equal(store._host_buf[: count + 30],
                                  np.concatenate([first, more]))
    q = rng.standard_normal((4, D)).astype(np.float32)
    assert store.batch_query(q, k=10) == kept.batch_query(q, k=10)


# --------------------------------------------- the two packages, one sequence

def make_store(which, path, device="cpu", **cfg):
    if which == "jax":
        return TPUVectorStore(path, JaxConfig(**cfg))
    return TorchVectorStore(path, VectorStoreConfig(**cfg), device=device)


def reopen(which, path, device="cpu"):
    return (TPUVectorStore(path) if which == "jax"
            else TorchVectorStore(path, device=device))


def assert_results_match(got, want, tol):
    """Per query: the same number of hits, scores rank by rank within
    tol, ids and metadata equal wherever the neighbouring scores are more
    than tol apart (near-ties may swap)."""
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


def assert_reranked(got, want):
    """Answers re-scored in f32 on the host from the same candidates."""
    for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
        assert gi == wi and gm == wm
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)


def capacity_config(dtype, ann):
    cfg = dict(dimension=D, metric="cosine", storage_dtype=dtype,
               persist_mode="lazy", initial_capacity=512, block_rows=256)
    if ann:
        cfg.update(enable_ann=True,
                   ann_params={"auto_flat_rows": 1000, "n_clusters": 16,
                               "nprobe": 4, "bucket_rows": 128})
    return cfg


def run_sequence(store, x, q, ann):
    """Adds (a grow through two doublings; with ANN a gather-IVF build,
    then an extend with spills), then the queries; returns the answers."""
    meta = [{"g": i % 10, "i": i} for i in range(len(x))]
    store.add_vectors(x[:1500], meta[:1500])
    store.add_vectors(x[1500:], meta[1500:])
    if ann:
        assert store._ann_kind == "ivf" and store._ann.size == len(x)
    out = {"exact": store.batch_query(q, k=10, use_ann=False),
           "top100": store.batch_query(q[:1], k=100, use_ann=False),
           "rerank": store.batch_query(q, k=10, rerank=True,
                                       use_ann=False),
           "filter": store.batch_query(q, k=10, use_ann=False,
                                       filter_metadata={"g": 3})}
    if ann:
        out["ann"] = store.batch_query(q, k=10)
        out["ann_rerank"] = store.batch_query(q, k=10, rerank=True)
        assert store._ann.get_stats()["layout"] == "gather"
    store.delete_vectors([int(i) for i in out["exact"][0][0][:2]] + [7])
    out["deleted"] = store.batch_query(q, k=10, use_ann=False)
    store.flush()
    return out


def compare_answers(got, want, tol):
    for key in got:
        if "rerank" in key:
            assert_reranked(got[key], want[key])
        else:
            assert_results_match(got[key], want[key], tol)


def reopened_answers(store, q, ann):
    out = {"exact": store.batch_query(q, k=10, use_ann=False),
           "rerank": store.batch_query(q, k=10, rerank=True, use_ann=False),
           "filter": store.batch_query(q, k=10, use_ann=False,
                                       filter_metadata={"g": 3})}
    if ann:
        # tombstones route the store's ANN queries to the exact scan:
        # ask the index itself
        ids, keys = store._ann_search(store._prepare_queries(q), 10)
        out["ann_index"] = [(list(i), list(np.clip(k, -1, 1)), [None] * 10)
                            for i, k in zip(ids.tolist(), keys)]
    return out


@pytest.mark.parametrize("ann", [False, True], ids=["exact", "gather_ivf"])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_capacity_sequence_matches_jax(tmp_path, dtype, ann):
    rng = np.random.default_rng(11)
    n = 3000
    x = clustered(rng, n) if ann else unit_rows(rng, n)
    q = x[[3, 700, 1600, 2999]] + 0.05 * rng.standard_normal(
        (4, D)).astype(np.float32)
    cfg = capacity_config(dtype, ann)
    js = make_store("jax", tmp_path / "jax", **cfg)
    ts = make_store("torch", tmp_path / "torch", **cfg)
    want = run_sequence(js, x, q, ann)
    got = run_sequence(ts, x, q, ann)
    compare_answers(got, want, TOL[dtype])
    assert ts.get_stats() == js.get_stats()
    if ann:
        for a, b in zip((ts._ann._ids, ts._ann._bucket_cluster),
                        (js._ann._ids, js._ann._bucket_cluster)):
            np.testing.assert_array_equal(a, b)
    # each package reopens its own files and the other's
    t_own = reopened_answers(reopen("torch", tmp_path / "torch"), q, ann)
    t_jax = reopened_answers(reopen("torch", tmp_path / "jax"), q, ann)
    j_own = reopened_answers(reopen("jax", tmp_path / "jax"), q, ann)
    j_torch = reopened_answers(reopen("jax", tmp_path / "torch"), q, ann)
    assert t_own["exact"] == got["deleted"]      # the same bytes again
    compare_answers(t_jax, j_own, TOL[dtype])
    compare_answers(j_torch, j_own, TOL[dtype])
    compare_answers(t_own, t_jax, TOL[dtype])


# ------------------------------- the capacity path's int8 regime, reduced

def tie_aware_hits(res, keys, k=10):
    """Returned ids whose exact f32 key reaches the exact k-th key (the
    capacity path's recall@10 rule)."""
    kth = np.sort(keys, axis=1)[:, -k]
    return sum(int(np.sum(keys[i, ids] >= kth[i] - 1e-6 - 1e-5 * abs(kth[i])))
               for i, (ids, _, _) in enumerate(res))


def test_int8_recall_in_capacity_regime_matches_jax(tmp_path):
    """chip_smoke.py's int8 capacity store at reduced rows: 768-dim unit
    rows, each its N(0, I) centre plus 0.2 N(0, I) (``clustered_rows``),
    about 2,048 rows a centre as 8M rows over 4,096 centres give, and
    queries that are stored rows plus 0.05 N(0, I) (noise of norm ~1.39,
    more than the row's own). The f32 top-10 is then a near-tie below
    int8's key error, so exact int8 and rerank=True both miss f32
    neighbours, in the JAX store as in the port: the same exact answers
    and recall, and rerank recalls apart by at most the queries whose
    40th and 41st int8 keys (the k x 4 candidates' edge) lie within the
    int8 tolerance, where either package may keep the other row."""
    rng = np.random.default_rng(21)
    d, centres, per, nq = 768, 4, 2048, 64
    c = rng.standard_normal((centres, d)).astype(np.float32)
    x = (np.repeat(c, per, axis=0)
         + 0.2 * rng.standard_normal((centres * per, d)).astype(np.float32))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = (x[rng.integers(0, len(x), nq)]
         + 0.05 * rng.standard_normal((nq, d)).astype(np.float32))
    keys = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ x.T
    cfg = dict(dimension=d, metric="cosine", storage_dtype="int8",
               persist_mode="off")
    got = {}
    for which in ("jax", "torch"):
        store = make_store(which, tmp_path / which, **cfg)
        store.add_vectors(x)
        got[which] = {
            "exact": store.batch_query(q, k=10, use_ann=False),
            "rerank": store.batch_query(q, k=10, rerank=True,
                                        use_ann=False),
            "edge": store.batch_query(q, k=41, use_ann=False)}
    assert_results_match(got["torch"]["exact"], got["jax"]["exact"],
                         TOL["int8"])
    exact = {w: tie_aware_hits(got[w]["exact"], keys) for w in got}
    rerank = {w: tie_aware_hits(got[w]["rerank"], keys) for w in got}
    assert exact["torch"] == exact["jax"] < nq * 10
    edge_ties = sum(abs(s[39] - s[40]) <= TOL["int8"]
                    for _, s, _ in got["jax"]["edge"])
    assert abs(rerank["torch"] - rerank["jax"]) <= edge_ties
    assert max(rerank.values()) < nq * 10


# ----------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ann", [False, True], ids=["exact", "gather_ivf"])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_capacity_sequence_on_card(tmp_path, card, dtype, ann):
    """The sequence on the card (its kernels, blocked uploads) against
    the CPU store (the kernels' plain versions), and the card's reopen."""
    rng = np.random.default_rng(12)
    n = 3000
    x = clustered(rng, n) if ann else unit_rows(rng, n)
    q = x[[3, 700, 1600, 2999]] + 0.05 * rng.standard_normal(
        (4, D)).astype(np.float32)
    cfg = capacity_config(dtype, ann)
    cpu = make_store("torch", tmp_path / "cpu", **cfg)
    gpu = make_store("torch", tmp_path / "gpu", device="cuda", **cfg)
    want = run_sequence(cpu, x, q, ann)
    got = run_sequence(gpu, x, q, ann)
    compare_answers(got, want, 1e-4)
    back = reopened_answers(reopen("torch", tmp_path / "gpu", "cuda"), q, ann)
    assert back["exact"] == got["deleted"]
    compare_answers(back, reopened_answers(
        reopen("torch", tmp_path / "cpu"), q, ann), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,dtype", BLOCK_DTYPES)
def test_blocked_upload_is_bit_identical_on_card(tmp_path, card, blocks,
                                                  metric, dtype):
    """On the card at d = 768: adds of 1,500 and 620 rows through a
    doubling, in blocks of 40, 17, 5 or 3 rows (blocks of fewer than 16
    rows too: the row reductions give a row the same bits in a block of
    any size), write the bytes of one-shot writes."""
    d = 768
    cfg = dict(dimension=d, metric=metric, storage_dtype=dtype,
               initial_capacity=1024, block_rows=1024)

    def make(path, config):
        return TorchVectorStore(path, config, device="cuda")

    states = []
    for rows in (40, 17, 5, 3, None):
        seen = blocks(rows, d)
        store = make(tmp_path / str(rows),
                     VectorStoreConfig(persist_mode="off", **cfg))
        rng = np.random.default_rng(9)
        for n in (1500, 620):                 # 2048, then in place
            store.add_vectors(rng.standard_normal((n, d)).astype(np.float32))
        assert rows is None or max(seen) <= rows
        states.append(device_bytes(store))
    for state in states[:-1]:
        assert_same_bytes(state, states[-1])
