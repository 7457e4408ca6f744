"""Property-based tests (hypothesis) of the port's top-k and merge
primitives and of ``TorchVectorStore`` under concurrency: the cases of
tests/test_properties.py over ``tpu_vector_db_torch``, at the JAX test's
``max_examples`` and with no deadline.

* ``ops/topk.py::top_k`` against a numpy sort;
* ``merge_small_k_plain`` (the k <= 32 merge's plain version) equal to
  the global top-k of two score matrices, and ``ops/topk.py::merge_topk``
  as the JAX test holds its ``merge_topk``;
* ``flat_topk_plain`` (the exact scan's plain version) and
  ``TorchVectorStore.batch_query`` sorted and within the live count, and
  held against the JAX package's ``flat_scan_topk`` at the same draws
  (ids equal away from ties, keys within 1e-5);
* concurrent adds and queries on one ``TorchVectorStore``.
"""

from __future__ import annotations

import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from tpu_vector_db.ops.scan import flat_scan_topk
from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
from tpu_vector_db_torch.ops.cuda_scan import flat_topk_plain
from tpu_vector_db_torch.ops.ivf_scan import merge_small_k_plain
from tpu_vector_db_torch.ops.topk import merge_topk, top_k

KEY_TOL = 1e-5


@st.composite
def score_matrix(draw):
    rows = draw(st.integers(1, 4))
    cols = draw(st.integers(1, 64))
    data = draw(st.lists(
        st.floats(-1e6, 1e6, allow_nan=False, width=32),
        min_size=rows * cols, max_size=rows * cols))
    return np.asarray(data, np.float32).reshape(rows, cols)


class TestTopKProperties:
    @settings(max_examples=50, deadline=None)
    @given(score_matrix(), st.integers(1, 20))
    def test_topk_matches_numpy_sort(self, scores, k):
        k = min(k, scores.shape[1])
        vals, idx = top_k(torch.from_numpy(scores), k)
        want = np.sort(scores, axis=-1)[:, ::-1][:, :k]
        np.testing.assert_allclose(vals.numpy(), want, rtol=1e-6)
        # indices must actually point at the returned values
        np.testing.assert_allclose(
            np.take_along_axis(scores, idx.long().numpy(), axis=-1), want,
            rtol=1e-6)

    @settings(max_examples=50, deadline=None)
    @given(score_matrix(), score_matrix(), st.integers(1, 16))
    def test_merge_equals_global(self, a, b, k):
        rows = min(a.shape[0], b.shape[0])
        a, b = a[:rows], b[:rows]
        ka = min(k, a.shape[1])
        kb = min(k, b.shape[1])
        va, ia = top_k(torch.from_numpy(a), ka)
        vb, ib = top_k(torch.from_numpy(b), kb)
        k_out = min(k, ka + kb)
        mv, _ = merge_topk(va, ia, vb, ib + a.shape[1], k_out)
        if ka == a.shape[1] and kb == b.shape[1]:
            allx = np.concatenate([a, b], axis=-1)
            want = np.sort(allx, axis=-1)[:, ::-1][:, :k_out]
            np.testing.assert_allclose(mv.numpy(), want, rtol=1e-6)
        else:
            # monotone non-increasing always holds
            assert np.all(np.diff(mv.numpy(), axis=-1) <= 1e-6)

    @settings(max_examples=50, deadline=None)
    @given(score_matrix(), score_matrix(), st.integers(1, 16))
    def test_merge_small_k_equals_global(self, a, b, k):
        """The two matrices' per-side top-k lists (global ids), merged by
        ``merge_small_k_plain``, are the global top-k of both matrices
        wherever a side was not cut; ids point at the keys; the order is
        key descending, then id ascending; -inf past the candidates."""
        rows = min(a.shape[0], b.shape[0])
        a, b = a[:rows], b[:rows]
        ka = min(k, a.shape[1])
        kb = min(k, b.shape[1])
        va, ia = top_k(torch.from_numpy(a), ka)
        vb, ib = top_k(torch.from_numpy(b), kb)
        keys = torch.cat([va, vb], dim=1)
        ids = torch.cat([ia, ib + a.shape[1]], dim=1).to(torch.int32)
        mv, mi = merge_small_k_plain(keys, ids, k)
        mv, mi = mv.numpy(), mi.numpy()
        n_live = min(k, ka + kb)
        assert mv.shape == (rows, k)
        assert np.all(np.isneginf(mv[:, n_live:]))
        assert np.all(mi[:, n_live:] == -1)
        allx = np.concatenate([a, b], axis=-1)
        np.testing.assert_array_equal(
            np.take_along_axis(allx, mi[:, :n_live].astype(np.int64),
                               axis=-1), mv[:, :n_live])
        for r in range(rows):
            pairs = list(zip(-mv[r, :n_live], mi[r, :n_live]))
            assert pairs == sorted(pairs)
        if ka == a.shape[1] and kb == b.shape[1]:
            want = np.sort(allx, axis=-1)[:, ::-1][:, :n_live]
            np.testing.assert_array_equal(mv[:, :n_live], want)

    @settings(max_examples=20, deadline=None)
    @given(st.integers(1, 200), st.integers(1, 3), st.integers(1, 15),
           st.integers(0, 2**31 - 1))
    def test_scan_results_sorted_and_within_count(self, n, q_n, k, seed):
        """flat_topk_plain over n live rows of a padded matrix: ids within
        [0, n), keys non-increasing, the -inf slots only past n; equal to
        the JAX package's flat_scan_topk on the same draw."""
        rng = np.random.default_rng(seed)
        d, block = 16, 64
        n_pad = ((n + block - 1) // block) * block
        db = np.zeros((n_pad, d), np.float32)
        db[:n] = rng.standard_normal((n, d))
        q = rng.standard_normal((q_n, d)).astype(np.float32)
        keys, idx = flat_topk_plain(torch.from_numpy(q), torch.from_numpy(db),
                                    n, k, metric="dot_product")
        keys, idx = keys.numpy(), idx.numpy()
        live = np.isfinite(keys)
        assert np.all(live.sum(axis=1) == min(k, n))
        assert np.all(idx[live] < n)
        assert np.all(idx[live] >= 0)
        for row in keys:
            finite = row[np.isfinite(row)]
            assert np.all(np.diff(finite) <= 1e-5)
        jkeys, jidx = flat_scan_topk(
            jnp.asarray(q), jnp.asarray(db), jnp.int32(n), k,
            metric="dot_product", block_rows=block)
        jkeys, jidx = np.asarray(jkeys), np.asarray(jidx)
        np.testing.assert_allclose(keys[live], jkeys[live], atol=KEY_TOL,
                                   rtol=KEY_TOL)
        assert np.all(np.isneginf(jkeys[~live]))
        # ids equal wherever the key is not tied with a neighbour's
        gaps = np.abs(np.diff(np.where(live, keys, 0.0), axis=1)) > KEY_TOL
        alone = live.copy()
        alone[:, 1:] &= gaps
        alone[:, :-1] &= gaps
        np.testing.assert_array_equal(idx[alone], jidx[alone])

    @settings(max_examples=20, deadline=None)
    @given(st.integers(1, 200), st.integers(1, 3), st.integers(1, 15),
           st.integers(0, 2**31 - 1))
    def test_store_results_sorted_and_within_count(self, n, q_n, k, seed):
        """TorchVectorStore.batch_query: min(k, live) results a query,
        every id live (deleted rows dropped), scores non-increasing, and
        the same ids and scores as the JAX package's flat_scan_topk on
        the store's own normalized rows."""
        rng = np.random.default_rng(seed)
        d = 16
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((q_n, d)).astype(np.float32)
        with tempfile.TemporaryDirectory() as tmp:
            store = TorchVectorStore(tmp, VectorStoreConfig(
                dimension=d, persist_mode="off"), device="cpu")
            store.add_vectors(x)
            dead = sorted(set(rng.integers(0, n, n // 10).tolist()))
            if dead:
                store.delete_vectors(dead)
            results = store.batch_query(q, k=k)
        live_n = n - len(dead)
        rows = store._db[:n].numpy()
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        qn = np.pad(qn, ((0, 0), (0, rows.shape[1] - d)))
        mask = np.ones(n, bool)
        mask[dead] = False
        jkeys, jidx = flat_scan_topk(
            jnp.asarray(qn), jnp.asarray(rows), jnp.int32(n), k,
            metric="cosine",
            db_normalized=True, filter_mask=jnp.asarray(mask),
            block_rows=n)
        jkeys, jidx = np.asarray(jkeys), np.asarray(jidx)
        for i, (ids, scores, _) in enumerate(results):
            assert len(ids) == min(k, live_n)
            assert all(0 <= j < n and mask[j] for j in ids)
            assert np.all(np.diff(scores) <= 1e-5)
            want = np.isfinite(jkeys[i])
            np.testing.assert_allclose(scores, jkeys[i][want],
                                       atol=KEY_TOL, rtol=0)
            s = np.asarray(scores)
            gaps = np.abs(np.diff(s)) > KEY_TOL
            alone = np.ones(len(s), bool)
            alone[1:] &= gaps
            alone[:-1] &= gaps
            np.testing.assert_array_equal(np.asarray(ids)[alone],
                                          jidx[i][want][alone])


class TestConcurrency:
    def test_concurrent_adds_and_queries(self, tmp_path, rng):
        """Concurrent writers and readers on one store never corrupt
        results: the readers always find their row first, and every
        write lands."""
        store = TorchVectorStore(tmp_path / "c", VectorStoreConfig(
            dimension=16, block_rows=64, initial_capacity=64,
            persist_mode="off"), device="cpu")
        base = rng.standard_normal((50, 16)).astype(np.float32)
        store.add_vectors(base, [{"i": i} for i in range(50)])
        errors: list[Exception] = []
        stop = threading.Event()

        def writer(tid):
            r = np.random.default_rng(tid)
            try:
                for _ in range(10):
                    store.add_vectors(
                        r.standard_normal((20, 16)).astype(np.float32))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def reader():
            try:
                while not stop.is_set():
                    idx, scores, meta = store.query(base[7], k=3)
                    assert idx[0] == 7          # original row stays found
                    assert scores[0] > 0.999
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(3)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for t in readers + threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads + readers)
        assert not errors, errors
        assert len(store) == 50 + 3 * 10 * 20
