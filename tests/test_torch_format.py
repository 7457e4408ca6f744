"""The store's result formatting (``TorchVectorStore._format_batch``), which
turns a batch's host (keys, ids) block into (indices, raw_scores,
metadata) lists a whole array at a time, held bit for bit against the
JAX store's per-result loop (``TPUVectorStore._format_results``) and,
on the ANN route, against that loop's rules written out here: equal ids
and Python floats (the sign of a zero distance included), the same
Python types, the same metadata dicts, in the same order.

On the CPU; no card is needed."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_vector_db.store.vector_store import TPUVectorStore

from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.monitoring import tracing
from tpu_vector_db_torch.ops.topk import NEG_INF
from tpu_vector_db_torch.store.vector_store import metadata_matches

torch.set_num_threads(1)

METRICS = ["cosine", "euclidean", "dot_product"]
N_META = 64
D = 16


class _Stub:
    """What the two formatters read of a store."""

    def __init__(self, metric):
        self.metric = metric
        self._metadata = [{"g": i % 3, "i": i} for i in range(N_META)]


def _block(metric, seed, q=4, width=12):
    """(keys, ids) of a search: keys in the metric's key convention
    (similarity, or minus the squared distance), descending a row."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(N_META)[:width] for _ in range(q)])
    keys = rng.uniform(-1.0, 1.0, (q, width)).astype(np.float32)
    if metric == "euclidean":
        keys = -np.abs(keys) * 4.0
    elif metric == "dot_product":
        keys = keys * 30.0
    return -np.sort(-keys, axis=1), ids.astype(np.int32)


def _case(metric, case):
    """(keys, ids, k, filter) for one case of the formatter's inputs."""
    keys, ids = _block(metric, seed=0)
    k, filt = keys.shape[1], None
    if case == "neg_inf_tail":
        keys[1, 8:] = NEG_INF
        keys[3, 3:] = NEG_INF
    elif case == "neg_inf_middle":
        keys[0, 5] = NEG_INF
        keys[2, [1, 4, 9]] = NEG_INF
    elif case == "filter_recheck":
        # the hash mask let through rows whose metadata the exact
        # re-check rejects; the cap at k counts the rows it keeps
        filt = {"g": 1}
        keys[3, 6:] = NEG_INF
        k = 2
    elif case == "k_below_width":
        keys[1, 2] = NEG_INF
        k = 5
    elif case == "signed_zero_and_above_one":
        keys[0, :5] = [1.25, 1.0000002, 0.0, -0.0, -1.5]
        keys[1, :4] = [0.0, -0.0, 1e-3, -1e-7]
        keys[2, 2] = 0.0
    return keys, ids, k, filt


def assert_same(got, want):
    """Equal rows: ids and scores by ``==``, each score's sign by
    ``math.copysign``, each value's Python type, metadata by ``is``."""
    assert len(got) == len(want)
    for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
        assert gi == wi
        assert [type(i) for i in gi] == [int] * len(wi)
        assert gs == ws
        assert [math.copysign(1.0, s) for s in gs] == \
            [math.copysign(1.0, s) for s in ws]
        assert [type(s) for s in gs] == [float] * len(ws)
        assert len(gm) == len(wm)
        assert all(a is b for a, b in zip(gm, wm))


@pytest.mark.parametrize("case", ["full", "neg_inf_tail", "neg_inf_middle",
                                  "filter_recheck", "k_below_width",
                                  "signed_zero_and_above_one"])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_route_formats_as_the_reference_loop(metric, case):
    stub = _Stub(metric)
    keys, ids, k, filt = _case(metric, case)
    want = [TPUVectorStore._format_results(stub, keys[r], ids[r], k, filt)
            for r in range(len(keys))]
    got = TorchVectorStore._format_batch(stub, keys, ids, k,
                                         keys != NEG_INF, filt)
    assert_same(got, want)
    if case == "signed_zero_and_above_one" and metric == "euclidean":
        # a key of exactly 0.0 is a distance of -0.0, as the loop gives
        assert math.copysign(1.0, got[0][1][2]) == -1.0
    if case == "filter_recheck":
        assert all(len(r[0]) == k for r in got[:3])
        assert all(m["g"] == 1 for r in got for m in r[2])


def _ann_reference(store, labels, keys, k, filt):
    """The ANN route's formatting rules, one result at a time: skip ids
    below 0 and tombstoned ids, stop at k, re-check a filter exactly,
    convert each key alone."""
    out = []
    for row_labels, row_keys in zip(labels, keys):
        indices, scores, metas = [], [], []
        for i, key in zip(row_labels, row_keys):
            i = int(i)
            if i < 0 or len(indices) >= k or i in store._deleted:
                continue
            meta = store._metadata[i]
            if filt and not metadata_matches(meta, filt):
                continue
            if store.metric == "euclidean":
                raw = float(np.sqrt(max(-key, 0.0)))
            elif store.metric == "cosine":
                raw = float(np.clip(key, -1.0, 1.0))
            else:
                raw = float(key)
            indices.append(i)
            scores.append(raw)
            metas.append(meta)
        out.append((indices, scores, metas))
    return out


def _store(tmp_path, metric="cosine", n=N_META, **cfg):
    store = TorchVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=D, metric=metric, persist_mode="off", **cfg),
        device="cpu")
    rows = np.random.default_rng(11).standard_normal((n, D)).astype(
        np.float32)
    store.add_vectors(rows, [{"g": i % 3, "i": i} for i in range(n)])
    return store, rows


@pytest.mark.parametrize("metric", METRICS)
def test_ann_route_drops_empty_and_tombstoned_ids(tmp_path, metric):
    """An index's block with -1 ids, a tombstoned id and a filter, through
    the ANN route's own mask, against the rules written out above."""
    store, rows = _store(tmp_path, metric)
    store.delete_vectors([5, 9])
    keys, labels = _block(metric, seed=3)
    keys[0, :4] = [1.5, 0.0, -0.0, 1e-3]
    labels[0, 1], labels[1, 0], labels[2, 3] = 5, 9, 5
    labels[1, 7:] = -1
    labels[3, [2, 5]] = -1
    store._ann_search = lambda queries, fetch_k: (labels, keys)
    for filt in (None, {"g": 2}):
        want = _ann_reference(store, labels, keys, 4, filt)
        keys_, ids_, valid_ = store._ann_batch_query(rows[:4], 4, filt)
        got = store._format_batch(keys_, ids_, 4, valid_, filt)
        assert_same(got, want)
        assert not any(i in (5, 9) or i < 0 for r in got for i in r[0])


def _spy(store, name):
    """Record what ``store.<name>`` returns."""
    seen, inner = [], getattr(store, name)

    def spy(*args, **kwargs):
        seen.append(inner(*args, **kwargs))
        return seen[-1]
    setattr(store, name, spy)
    return seen


@pytest.mark.parametrize("filt", [None, {"g": 1}])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_store_answers_as_the_reference_loop(tmp_path, metric, filt):
    """A flat store with deletions: batch_query's answers are the JAX
    loop's formatting of the block the scan returned."""
    store, rows = _store(tmp_path, metric, n=300)
    store.delete_vectors([0, 4, 7, 100])
    seen = _spy(store, "_flat_topk")
    k = 20
    got = store.batch_query(rows[:6], k=k, filter_metadata=filt)
    keys, ids = seen[-1]
    want = [TPUVectorStore._format_results(store, keys[r], ids[r], k, filt)
            for r in range(6)]
    assert_same(got, want)
    assert all(len(r[0]) == k for r in got)
    assert not any(i in (0, 4, 7, 100) for r in got for i in r[0])
    if filt:
        assert all(m["g"] == 1 for r in got for m in r[2])


@pytest.mark.parametrize("filt", [None, {"g": 1}])
def test_ivf_store_answers_as_the_reference_loop(tmp_path, filt):
    """An IVF store with deletions: batch_query's answers are the ANN
    route's rules applied to the block the index returned."""
    store, rows = _store(tmp_path, n=800, enable_ann=True, ann_params={
        "index_type": "ivf", "n_clusters": 8, "nprobe": 8})
    store.delete_vectors([1, 2, 30, 400])
    seen = _spy(store, "_ann_search")
    k = 3
    got = store.batch_query(rows[:5], k=k, filter_metadata=filt)
    assert len(seen) == 1     # the IVF route served the batch
    labels, keys = seen[-1]
    want = _ann_reference(store, labels, keys, k, filt)[:5]
    assert_same(got, want)
    assert all(len(r[0]) == k for r in got)
    assert not any(i in (1, 2, 30, 400) for r in got for i in r[0])


@pytest.mark.parametrize("filt", [None, {"g": 2}])
def test_format_span_counts_results_and_rechecks(tmp_path, filt):
    store, rows = _store(tmp_path, n=200)
    store.delete_vectors([3])
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = store.batch_query(rows[:4], k=6, filter_metadata=filt)
        spans = [s for s in tracing.spans() if s["name"] == "store.format"]
    finally:
        tracing.reset()
    assert len(spans) == 1
    attrs = spans[0]["attrs"]
    assert attrs["size"] == sum(len(r[0]) for r in out) == 24
    if filt:
        assert attrs["rechecked"] >= attrs["size"]
    else:
        assert attrs["rechecked"] == 0
