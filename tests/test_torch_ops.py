"""The port's ops, utils and config (tpu_vector_db_torch) against the JAX
package's functions on the same inputs, made from a seed with numpy.

Tolerances: f32 products in another summation order agree to 1e-5 on
unit-scale data; quantizers and packers must be byte-identical.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.ops import distance as JD
from tpu_vector_db.ops import quant4 as JQ
from tpu_vector_db.ops.scan import flat_scan_topk as jax_flat_scan_topk
from tpu_vector_db.ops.topk import merge_topk as jax_merge_topk
from tpu_vector_db.ops.topk import top_k as jax_top_k
from tpu_vector_db.ops.topk import topk_with_mask as jax_topk_with_mask
from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.utils.validation import (
    validate_vector_shape as jax_validate)

from tpu_vector_db_torch.ops import distance as TD
from tpu_vector_db_torch.ops import quant4 as TQ
from tpu_vector_db_torch.ops.monitor import PerformanceMonitor
from tpu_vector_db_torch.ops.scan import flat_scan_topk
from tpu_vector_db_torch.ops.topk import merge_topk, top_k, topk_with_mask
from tpu_vector_db_torch.store.config import (StoreCapacityError,
                                              VectorStoreConfig)
from tpu_vector_db_torch.utils import (FileLock, atomic_save_npz,
                                       atomic_write_bytes,
                                       validate_vector_shape)
from tpu_vector_db_torch.utils.concurrency import RWLock

torch.set_num_threads(1)


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


def _data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- distance

@pytest.mark.parametrize("d,multiple", [(100, 128), (128, 128), (300, 256)])
def test_pad_dim(d, multiple):
    x = _data(0, (3, d))
    got = TD.pad_dim(torch.from_numpy(x), multiple)
    want = JD.pad_dim(jnp.asarray(x), multiple)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_rows():
    x = _data(1, (10, 8))
    np.testing.assert_array_equal(
        TD.pad_rows(torch.from_numpy(x), 16).numpy(),
        np.asarray(JD.pad_rows(jnp.asarray(x), 16)))


def test_l2_normalize_and_eps():
    x = _data(2, (6, 64))
    x[2] = 0.0
    got = TD.l2_normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(JD.l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert TD.EPS == JD.EPS and np.all(got[2] == 0.0)


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "euclidean"])
def test_score_matrix(metric):
    q, db = _data(3, (4, 64)), _data(4, (50, 64))
    got = TD.score_matrix(torch.from_numpy(q), torch.from_numpy(db), metric)
    want = JD.score_matrix(jnp.asarray(q), jnp.asarray(db), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_euclidean_distances():
    q, db = _data(5, (3, 32)), _data(6, (40, 32))
    got = TD.euclidean_distances(torch.from_numpy(q), torch.from_numpy(db))
    want = JD.euclidean_distances(jnp.asarray(q), jnp.asarray(db))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "euclidean"])
def test_key_and_score_conventions(metric):
    keys = np.array([-4.0, -0.25, 0.5], np.float32)
    got = TD.key_to_raw_score(torch.from_numpy(keys), metric).numpy()
    want = np.asarray(JD.key_to_raw_score(jnp.asarray(keys), metric))
    np.testing.assert_allclose(got, want, atol=1e-7)
    for s in (0.0, 0.75, 2.0):
        assert TD.raw_score_to_similarity_distance(s, metric) == \
            JD.raw_score_to_similarity_distance(s, metric)
    with pytest.raises(ValueError):
        TD.raw_score_to_similarity_distance(1.0, "hamming")


# ---------------------------------------------------------------- top-k

@pytest.mark.parametrize("largest", [True, False])
def test_top_k(largest):
    s = _data(7, (4, 300))
    gv, gi = top_k(torch.from_numpy(s), 17, largest=largest)
    wv, wi = jax_top_k(jnp.asarray(s), 17, largest=largest)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_top_k_ties_lower_index_first():
    s = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    _, gi = top_k(torch.from_numpy(s), 3)
    _, wi = jax_top_k(jnp.asarray(s), 3)
    assert gi.tolist() == [[1, 2, 4]] == np.asarray(wi).tolist()


def test_merge_topk():
    va, vb = _data(8, (3, 10)), _data(9, (3, 20))
    ia = np.arange(30, dtype=np.int32).reshape(3, 10)
    ib = np.arange(100, 160, dtype=np.int32).reshape(3, 20)
    va = -np.sort(-va, axis=1)
    gv, gi = merge_topk(torch.from_numpy(va), torch.from_numpy(ia),
                        torch.from_numpy(vb), torch.from_numpy(ib), 10)
    wv, wi = jax_merge_topk(jnp.asarray(va), jnp.asarray(ia),
                            jnp.asarray(vb), jnp.asarray(ib), 10)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_topk_with_mask():
    s = _data(10, (2, 64))
    m = np.random.default_rng(11).random(64) < 0.4
    gv, gi = topk_with_mask(torch.from_numpy(s), torch.from_numpy(m), 5)
    wv, wi = jax_topk_with_mask(jnp.asarray(s), jnp.asarray(m), 5)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# --------------------------------------------------------------- quant4

@pytest.mark.parametrize("normalize", [True, False])
def test_pack_int4_byte_identical(normalize):
    x = _data(12, (64, 256)) * 2.0
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    gp, gs = TQ.pack_int4(torch.from_numpy(x), normalize=normalize)
    wp, ws = JQ.pack_int4(jnp.asarray(x), normalize=normalize)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(
        TQ.unpack_int4(gp, gs).numpy(),
        np.asarray(JQ.unpack_int4(wp, ws)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        TQ.dequant_sqnorms(gp, gs).numpy(),
        np.asarray(JQ.dequant_sqnorms(wp, ws)), rtol=1e-5)


def test_quantize_unit_rows_int8_identical():
    x = _data(13, (32, 128))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    g, gs = TQ.quantize_unit_rows(torch.from_numpy(x), "int8")
    w, ws = JQ.quantize_unit_rows(jnp.asarray(x), "int8")
    assert gs is None and ws is None
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        TQ.quantize_unit_rows(torch.from_numpy(x), "float32")


# ----------------------------------------------------------------- scan

@pytest.mark.parametrize("metric,dtype", [
    ("cosine", "float32"), ("euclidean", "float32"),
    ("dot_product", "float32"), ("cosine", "bfloat16"),
    ("cosine", "int8"), ("cosine", "int4")])
def test_flat_scan_topk(metric, dtype):
    """Blockwise plain scan (ops/scan.py) vs the JAX package's XLA scan,
    filter mask and count < N included."""
    n, d = 4096, 256
    x, q = _data(14, (n, d)), _data(15, (4, d))
    mask = np.random.default_rng(16).random(n) < 0.5
    sq = np.sum(x * x, axis=1) if metric == "euclidean" else None
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    scales = None
    if dtype == "int8":
        tx = torch.from_numpy(np.clip(np.round(x * 127), -127, 127)
                              .astype(np.int8))
    elif dtype == "int4":
        tx, ts = TQ.pack_int4(torch.from_numpy(x))
        scales = ts.numpy()
    else:
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy() if dtype == "bfloat16"
                     else tx.numpy())
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
    kw = dict(metric=metric, db_normalized=metric == "cosine",
              block_rows=1024)
    gv, gi = flat_scan_topk(
        torch.from_numpy(q), tx, 4000, 20,
        db_sqnorms=None if sq is None else torch.from_numpy(sq),
        filter_mask=torch.from_numpy(mask),
        db_scales=None if scales is None else torch.from_numpy(scales),
        **kw)
    wv, wi = jax_flat_scan_topk(
        jnp.asarray(q), jx, jnp.int32(4000), 20,
        db_sqnorms=None if sq is None else jnp.asarray(sq),
        filter_mask=jnp.asarray(mask),
        db_scales=None if scales is None else jnp.asarray(scales), **kw)
    tol = 1e-3 if metric == "euclidean" else 1e-4
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=tol)
    assert (gi.numpy() == np.asarray(wi)).mean() > 0.95
    assert np.all(mask[gi.numpy()]) and np.all(gi.numpy() < 4000)


# -------------------------------------------------------------- monitor

def test_performance_monitor():
    mon = PerformanceMonitor()

    @mon.timed("f")
    def f(x):
        return x * 2

    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    mon.record("g", 0.5)
    stats = mon.get_stats()
    assert stats["f"]["calls"] == 1 and stats["g"]["avg_time_ms"] == 500.0
    mon.reset()
    assert mon.get_stats() == {}


# ---------------------------------------------------------------- utils

@pytest.mark.parametrize("bad", [np.zeros((2, 3, 4)), np.zeros((2, 5)),
                                 np.array([[np.nan] * 4])])
def test_validate_vector_shape_rejects(bad):
    for fn in (validate_vector_shape, jax_validate):
        with pytest.raises(ValueError):
            fn(bad, 4)


def test_validate_vector_shape_coerces():
    got = validate_vector_shape([1, 2, 3, 4], 4)
    assert got.shape == (1, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_validate([1, 2, 3, 4], 4))


def test_atomic_writes_and_lock(tmp_path):
    atomic_write_bytes(tmp_path / "a.bin", b"abc")
    assert (tmp_path / "a.bin").read_bytes() == b"abc"
    atomic_save_npz(tmp_path / "b.npz", ids=np.arange(3))
    with np.load(tmp_path / "b.npz") as z:
        assert z["ids"].tolist() == [0, 1, 2]
    assert not list(tmp_path.glob("*.tmp"))
    with FileLock(tmp_path):
        assert (tmp_path / ".store.lock").exists()


def test_rwlock_excludes_writer_from_readers():
    lock, log = RWLock(), []
    with lock.read():
        t = threading.Thread(target=lambda: lock.write().__enter__()
                             or log.append("w"))
        t.start()
        t.join(0.2)
        assert log == []          # writer waits while a reader holds
    t.join(5)
    assert log == ["w"] and not t.is_alive()
    lock.release_write()


# --------------------------------------------------------------- config

def test_config_roundtrips_jax_manifest():
    jcfg = JaxConfig(dimension=200, metric="euclidean",
                     storage_dtype="bfloat16", use_pallas=False,
                     jit_compile=False, persist_mode="lazy")
    d = json.loads(json.dumps(jcfg.to_dict()))
    cfg = VectorStoreConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert JaxConfig.from_dict(cfg.to_dict()).to_dict() == d


@pytest.mark.parametrize("kwargs", [
    {"metric": "hamming"}, {"storage_dtype": "fp8"},
    {"persist_mode": "never"}, {"dimension": 0},
    {"storage_dtype": "int8", "metric": "euclidean"},
    {"ann_params": {"index_type": "hnsw"}}])
def test_config_validation_matches(kwargs):
    for cls in (VectorStoreConfig, JaxConfig):
        with pytest.raises(ValueError):
            cls(**kwargs)


def test_capacity_guard(monkeypatch):
    monkeypatch.setenv("VDB_HBM_BYTES", str(64 * 2**20))
    cfg = VectorStoreConfig(dimension=768, initial_capacity=1)
    jcfg = JaxConfig(dimension=768, initial_capacity=1)
    assert cfg.device_budget_bytes() == jcfg.device_budget_bytes()
    assert cfg.max_feasible_rows() == jcfg.max_feasible_rows()
    with pytest.raises(StoreCapacityError, match="int4"):
        cfg.check_device_budget(1_000_000)
    with pytest.raises(StoreCapacityError):
        VectorStoreConfig(dimension=768, initial_capacity=1_000_000)
