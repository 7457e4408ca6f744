"""TorchVectorStore (device="cpu") against TPUVectorStore: the same
operations on the same data, made from a seed with numpy, give the same
results; a store saved by either package opens in the other.

On the CPU the JAX store scans with its XLA engine and the torch store
with the flat kernel's plain version. Tolerances: scores to 1e-4 (f32
sums in another order; euclidean distances to 1e-3). int8 stores differ
by the query's bf16 rounding (the torch scan rounds queries as the TPU
kernel does; the JAX XLA scan does not), so their scores agree to 5e-3.
int4 stores differ in the folded nibble offset 8*s*sum(q), which the TPU
kernel and the torch scan take over the bf16-rounded query and the JAX
XLA scan over the f32 one: 3e-3. Ids are compared exactly away from
near-ties.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.store.vector_store import TPUVectorStore

from tpu_vector_db_torch import (TorchVectorStore, VectorStoreConfig,
                                 create_vector_store)
from tpu_vector_db_torch.ops.launches import LAUNCHES

torch.set_num_threads(1)

N, D = 3000, 64


def _rows(seed, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _meta(n, start=0):
    return [{"g": (start + i) % 5, "i": start + i} for i in range(n)]


def _pair(tmp_path, **cfg):
    """A JAX store and a torch store with the same config."""
    cfg.setdefault("persist_mode", "off")
    jax_store = TPUVectorStore(tmp_path / "jax", JaxConfig(dimension=D,
                                                           **cfg))
    torch_store = TorchVectorStore(tmp_path / "torch",
                                   VectorStoreConfig(dimension=D, **cfg),
                                   device="cpu")
    return jax_store, torch_store


def assert_results_match(got, want, tol):
    """Per query: the same number of hits, scores rank by rank within
    tol, ids equal wherever the neighbouring scores are more than tol
    apart (near-ties may swap)."""
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


STORE_CASES = [("cosine", "float32", 1e-4), ("euclidean", "float32", 1e-3),
               ("dot_product", "float32", 1e-4),
               ("cosine", "bfloat16", 1e-4), ("cosine", "int8", 5e-3),
               ("cosine", "int4", 3e-3)]


@pytest.mark.parametrize("metric,dtype,tol", STORE_CASES)
def test_store_parity(tmp_path, metric, dtype, tol):
    """adds with metadata (crossing a capacity doubling), delete,
    batch top-10, filtered query, top-100, get_stats."""
    js, ts = _pair(tmp_path, metric=metric, storage_dtype=dtype,
                   initial_capacity=2048, block_rows=1024)
    x = _rows(1)
    for s in (js, ts):
        s.add_vectors(x[:1500], _meta(1500))
        s.add_vectors(x[1500:], _meta(N - 1500, 1500))
    q = x[[3, 200, 1234]] + 0.1 * _rows(2, 3)
    assert_results_match(ts.batch_query(q, k=10), js.batch_query(q, k=10),
                         tol)
    for s in (js, ts):
        assert s.delete_vectors([3, 200, 2999]) == {"deleted": 3,
                                                    "live": N - 3}
    assert_results_match(ts.batch_query(q, k=10), js.batch_query(q, k=10),
                         tol)
    f = {"g": 2}
    got = ts.batch_query(q, k=10, filter_metadata=f)
    assert_results_match(got, js.batch_query(q, k=10, filter_metadata=f),
                         tol)
    assert all(m["g"] == 2 for r in got for m in r[2])
    assert_results_match(ts.batch_query(q[:1], k=100),
                         js.batch_query(q[:1], k=100), tol)
    assert ts.get_stats() == js.get_stats()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_bf16_rerank_parity(tmp_path, metric):
    """rerank=True on a bf16 store: the k*4 oversample (k=10 -> 40, the
    big-k kernel's range) re-scored against the f32 host rows."""
    js, ts = _pair(tmp_path, metric=metric, storage_dtype="bfloat16")
    x = _rows(3)
    for s in (js, ts):
        s.add_vectors(x, _meta(N))
    q = x[:2] + 0.2 * _rows(4, 2)
    got = ts.batch_query(q, k=10, rerank=True)
    want = js.batch_query(q, k=10, rerank=True)
    for (gi, gs, _), (wi, ws, _) in zip(got, want):
        assert gi == wi
        np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("dtype,k,rerank", [("float32", 1025, False),
                                            ("float32", 2000, False),
                                            ("bfloat16", 300, True)])
def test_scan_width_limit(tmp_path, dtype, k, rerank):
    """The exact scan has no width limit: past the TPU big-k kernel's 1024
    rows per query (k, or k x the rerank oversample of 4) the JAX store
    uses its XLA scan and the torch store its big-k kernel (on the CPU, the
    kernel's plain version); both give the same results."""
    js, ts = _pair(tmp_path, storage_dtype=dtype)
    x = _rows(11)
    for s in (js, ts):
        s.add_vectors(x, _meta(N))
    q = x[:2] + 0.1 * _rows(12, 2)
    want = js.batch_query(q, k=k, rerank=rerank)
    got = ts.batch_query(q, k=k, rerank=rerank)
    assert [len(r[0]) for r in got] == [k, k]
    if rerank:   # both re-score the same candidates in f32 on the host
        for (gi, gs, _), (wi, ws, _) in zip(got, want):
            assert gi == wi
            np.testing.assert_allclose(gs, ws, rtol=1e-6)
    else:
        assert_results_match(got, want, 1e-4)


def test_query_contract(tmp_path):
    js, ts = _pair(tmp_path)
    x = _rows(5, 20)
    for s in (js, ts):
        s.add_vectors(x, _meta(20))
        assert s.query(x[4], k=50)[0][:1] == [4]          # k clamps
        assert len(s.query(x[4], k=50)[0]) == 20
        assert s.query(x[4], filter_metadata={"g": 99}) == ([], [], [])
        with pytest.raises(ValueError):
            s.query(x[4], k=0)
        with pytest.raises(ValueError):
            s.add_vectors(np.zeros((2, D + 1), np.float32))
        with pytest.raises(ValueError):
            s.add_vectors(np.full((1, D), np.nan, np.float32))
    assert ts.query(x[4], k=3)[1][0] > 0.999
    assert ts.get_vectors([1, 2]).tolist() == js.get_vectors([1, 2]).tolist()
    assert ts.get_metadata([7]) == js.get_metadata([7])
    for s in (js, ts):
        s.delete_vectors([1])
        with pytest.raises(KeyError):
            s.get_vectors([1])
        with pytest.raises(KeyError):
            s.get_metadata([1])
    assert ts.get_vectors().shape == js.get_vectors().shape == (19, D)


def test_compact_and_clear_parity(tmp_path):
    js, ts = _pair(tmp_path, initial_capacity=1024, block_rows=1024)
    x = _rows(6)
    for s in (js, ts):
        s.add_vectors(x, _meta(N))
        s.delete_vectors(list(range(0, N, 2)))
    assert ts.compact() == js.compact()
    assert ts.get_stats() == js.get_stats()
    q = x[[1, 3]]
    assert_results_match(ts.batch_query(q, k=5), js.batch_query(q, k=5),
                         1e-4)
    assert ts.optimize()["capacity"] == js.optimize()["capacity"]
    for s in (js, ts):
        s.clear()
    assert ts.get_stats() == js.get_stats()
    assert ts.batch_query(q, k=5) == [([], [], []), ([], [], [])]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_persistence_across_packages(tmp_path, direction):
    """Rows, ids, metadata, tombstones and top-k survive a save by one
    package and a load by the other (same files, FORMAT_VERSION 1)."""
    path = tmp_path / "store"
    x = _rows(7)
    kw = dict(dimension=D, metric="euclidean", storage_dtype="float32")
    if direction == "jax_to_torch":
        writer = TPUVectorStore(path, JaxConfig(persist_mode="lazy", **kw))
    else:
        writer = create_vector_store(path, device="cpu",
                                     persist_mode="lazy", **kw)
    writer.add_vectors(x, _meta(N))
    writer.delete_vectors([10, 11])
    q = x[[10, 50]] + 0.05
    before = writer.batch_query(q, k=10)
    writer.flush()
    if direction == "jax_to_torch":
        reader = TorchVectorStore(path, device="cpu")
    else:
        reader = TPUVectorStore(path)
    assert reader.config.to_dict() == writer.config.to_dict()
    assert reader.get_stats() == writer.get_stats()
    np.testing.assert_array_equal(reader.get_vectors(), writer.get_vectors())
    assert reader.get_metadata([0, 2999]) == writer.get_metadata([0, 2999])
    assert_results_match(reader.batch_query(q, k=10), before, 1e-3)


def test_sync_saves_write_the_jax_files(tmp_path):
    """A sync store writes, after every mutation, the files the JAX store
    writes: metadata.jsonl byte for byte, the same rows and manifest,
    across adds, a compact, a clear and a reopen (the torch store keeps
    the lines of rows it encoded before and encodes only new ones)."""
    js, ts = _pair(tmp_path, persist_mode="sync")
    x = _rows(9, 300)
    meta = [{"i": i, "name": f"ünï {i}", "tags": [i % 3]} for i in range(300)]

    def same_files():
        for name in ("metadata.jsonl", "tombstones.npz"):
            a, b = tmp_path / "jax" / name, tmp_path / "torch" / name
            assert a.exists() == b.exists()
            if name.endswith(".jsonl"):
                assert a.read_bytes() == b.read_bytes()
        with np.load(tmp_path / "jax" / "vectors.npz") as a, \
                np.load(tmp_path / "torch" / "vectors.npz") as b:
            np.testing.assert_array_equal(a["vectors"], b["vectors"])
        import json
        assert json.loads((tmp_path / "torch" / "manifest.json").read_text()
                          ) == json.loads((tmp_path / "jax" /
                                           "manifest.json").read_text())

    for start in (0, 100, 200):
        for s in (js, ts):
            s.add_vectors(x[start:start + 100], meta[start:start + 100])
        same_files()
    for s in (js, ts):
        s.delete_vectors([3, 150])
        s.compact()
        s.add_vectors(x[:7], meta[:7])
    same_files()
    js, ts = (TPUVectorStore(tmp_path / "jax"),
              TorchVectorStore(tmp_path / "torch", device="cpu"))
    for s in (js, ts):
        s.add_vectors(x[7:9], meta[7:9])
    same_files()
    for s in (js, ts):
        s.clear()
        s.add_vectors(x[:2], meta[:2])
    same_files()


def test_manifest_config_wins_on_reopen(tmp_path):
    s = create_vector_store(tmp_path / "s", dimension=32,
                            metric="dot_product", device="cpu")
    s.add_vectors(_rows(8, 10, 32))
    reopened = TorchVectorStore(tmp_path / "s", device="cpu")
    assert reopened.config.metric == "dot_product" and len(reopened) == 10
    with pytest.raises(ValueError, match="metric"):
        TorchVectorStore(tmp_path / "s", VectorStoreConfig(dimension=32),
                         device="cpu")


def test_no_kernel_launch_on_cpu(tmp_path):
    s = create_vector_store(tmp_path / "s", dimension=D, device="cpu",
                            persist_mode="off")
    s.add_vectors(_rows(9, 100))
    before = dict(LAUNCHES)
    s.batch_query(_rows(10, 2), k=50)
    assert LAUNCHES == before


def test_device_defaults_to_cuda(tmp_path):
    """Without device='cpu' the store runs on the card, and raises when
    there is none: nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVectorStore(tmp_path / "a")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_vector_store(tmp_path / "b", dimension=D)


def test_enable_ann_is_not_served_by_flat(tmp_path):
    """enable_ann=True builds an index: the beam graph (which raised
    NotImplementedError until it was ported) for index_type="beam_graph",
    the IVF index past auto_flat_rows."""
    from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex
    g = create_vector_store(tmp_path / "s", dimension=D, device="cpu",
                            enable_ann=True, persist_mode="off",
                            ann_params={"index_type": "beam_graph", "M": 4,
                                        "ef_construction": 32})
    g.add_vectors(_rows(12, 300))
    assert isinstance(g._ann, BeamGraphIndex) and g._ann.size == 300
    assert g.get_stats()["index_type"] == "beam_graph"
    s = create_vector_store(tmp_path / "t", dimension=D, device="cpu",
                            enable_ann=True, persist_mode="off",
                            ann_params={"auto_flat_rows": 1000})
    s.add_vectors(_rows(13, 1500))
    assert s.get_stats()["index_type"] == "ivf"


def test_import_pulls_in_no_jax():
    """Importing the port loads neither jax nor the JAX package."""
    code = ("import sys, tpu_vector_db_torch, tpu_vector_db_torch.ops."
            "cuda_scan, tpu_vector_db_torch.ops.scan, "
            "tpu_vector_db_torch.ops._build, tpu_vector_db_torch.ops."
            "kmeans, tpu_vector_db_torch.ops.ivf_scan, "
            "tpu_vector_db_torch.ops.launches, "
            "tpu_vector_db_torch.index.ivf, "
            "tpu_vector_db_torch.index.beam_graph, "
            "tpu_vector_db_torch.index.native, "
            "tpu_vector_db_torch.pipeline._native, "
            "tpu_vector_db_torch.sdk, tpu_vector_db_torch.sdk.client\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpu_vector_db' or "
            "m.startswith('tpu_vector_db.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
