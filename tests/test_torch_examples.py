"""The port's examples (``examples/torch_*.py``) on the CPU.

Each example runs through its ``main(device="cpu", root=tmp_path)`` and
is held to what it prints and asserts. ``torch_quickstart``,
``torch_ivf_index`` and ``torch_capacity_mode`` are also held against
the same calls on the JAX package's ``TPUVectorStore`` (on the CPU it
scans with XLA, not Pallas) over the same seeded inputs: ids equal
(bf16: by score, ties allowed), scores within the dtype's tolerance. No
example imports ``jax`` or ``tpu_vector_db``, and with the default
device and no card each one raises instead of running on the CPU.

Sizes are the JAX examples' own, but one: ``torch_ann_index`` runs at
5,000 rows (20,000 in the example) to keep its native graph build short
on a test worker.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_vector_db.store.config import VectorStoreConfig as JaxConfig
from tpu_vector_db.store.vector_store import TPUVectorStore

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
NAMES = ("quickstart", "ann_index", "ivf_index", "capacity_mode",
         "rag_pipeline", "rest_and_sdk", "sharded_mesh")
F32_TOL = 1e-4          # f32 sums in another order
BF16_TOL = 6e-3         # the JAX tests' bf16 / quantized scoring tolerance


def example(name: str):
    """examples/torch_<name>.py, imported by its path."""
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same_ids_by_score(got, want, tol: float) -> None:
    """Equal answers up to ties: scores within ``tol`` position by
    position, and every id that differs sits on a score tied (within
    ``tol``) with the other answer's id at that position."""
    g_ids, g_scores = list(got[0]), np.asarray(got[1], np.float32)
    w_ids, w_scores = list(want[0]), np.asarray(want[1], np.float32)
    assert len(g_ids) == len(w_ids)
    np.testing.assert_allclose(g_scores, w_scores, atol=tol, rtol=0)
    for i, (a, b) in enumerate(zip(g_ids, w_ids)):
        if a != b:
            assert abs(g_scores[i] - w_scores[i]) <= tol, (g_ids, w_ids)


def test_quickstart_matches_jax(tmp_path):
    out = example("quickstart").main(device="cpu", root=tmp_path)
    assert out["count"] == out["reloaded_count"] == 1000
    assert out["self_query"][0][0] == 42
    assert out["filtered"][2] == ["de"] * 3
    assert [r[0][0] for r in out["batch"]] == list(range(8))
    assert out["parity"] and out["reloaded_top1"] == [42]
    assert out["stats"]["storage_dtype"] == "bfloat16"
    assert str(out["store"].device) == "cpu"

    # the same calls on the JAX store (bf16 rows)
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((1000, 384)).astype(np.float32)
    jstore = TPUVectorStore(tmp_path / "jax", JaxConfig(
        dimension=384, metric="cosine", storage_dtype="bfloat16"))
    jstore.add_vectors(docs, [
        {"doc_id": f"doc_{i}", "lang": "en" if i % 2 else "de"}
        for i in range(1000)])
    ids, scores, _ = jstore.query(docs[42], k=3)
    same_ids_by_score(out["self_query"], (ids, scores), BF16_TOL)
    ids, scores, meta = jstore.query(docs[42], k=3,
                                     filter_metadata={"lang": "de"})
    same_ids_by_score(out["filtered"], (ids, scores), BF16_TOL)
    for got, want in zip(out["batch"], jstore.batch_query(docs[:8], k=2)):
        same_ids_by_score(got, want, BF16_TOL)


def test_ann_index(tmp_path):
    from tpu_vector_db_torch.index import native
    if not native.available():
        pytest.skip("the native graph builder needs g++")
    out = example("ann_index").main(device="cpu", root=tmp_path, n=5_000)
    assert out["index"]["type"] == "beam_graph"
    assert out["index"]["nodes"] == 5_000
    assert out["recall"] >= 0.95
    assert out["graph_nodes"] == 6_000 and out["reachable"]


def test_ivf_index_matches_jax(tmp_path):
    mod = example("ivf_index")
    out = mod.main(device="cpu", root=tmp_path)
    assert out["index_type"] == "ivf"
    assert out["recall"] >= 0.95
    assert out["count"] == 50_500

    # the same calls on the JAX store: the same k-means, the same probe
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((64, 128)).astype(np.float32) * 3
    x = (mu[rng.integers(0, 64, 50_000)]
         + rng.standard_normal((50_000, 128))).astype(np.float32)
    jstore = TPUVectorStore(tmp_path / "jax", JaxConfig(
        dimension=128, enable_ann=True, persist_mode="off",
        ann_params={"index_type": "ivf", "nprobe": 32,
                    "min_rows": 10_000}))
    jstore.add_vectors(x, [{"i": i} for i in range(50_000)])
    jstore.optimize()
    assert jstore.get_stats()["index_type"] == "ivf"
    for i, q in enumerate(out["queries"]):
        ids, scores, _ = jstore.query(q, k=10)
        same_ids_by_score(out["ivf"][i], (ids, scores), F32_TOL)
        ids, scores, _ = jstore.query(q, k=10, use_ann=False)
        same_ids_by_score(out["exact"][i], (ids, scores), F32_TOL)


def test_capacity_mode_matches_jax(tmp_path):
    out = example("capacity_mode").main(device="cpu", root=tmp_path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50_000, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for dtype in ("int8", "int4"):
        got = out[dtype]
        assert got["index_type"] == "ivf" and got["layout"] == "gather"
        assert got["ivf"][0][0] == got["exact"][0][0] == 123
        assert got["ivf"][1][0] > 0.95          # the example's assert
        jstore = TPUVectorStore(tmp_path / f"jax_{dtype}", JaxConfig(
            dimension=256, storage_dtype=dtype, enable_ann=True,
            persist_mode="off",
            ann_params={"index_type": "ivf", "nprobe": 16,
                        "self_check": False}))
        jstore.add_vectors(x, [{"i": i} for i in range(50_000)])
        ids, scores, _ = jstore.query(x[123], k=5)
        same_ids_by_score(got["ivf"], (ids, scores), BF16_TOL)
        exact = jstore.batch_query(x[123][None], k=5, use_ann=False)[0]
        same_ids_by_score(got["exact"], exact, BF16_TOL)


def test_rag_pipeline(tmp_path):
    mod = example("rag_pipeline")
    out = mod.main(device="cpu", root=tmp_path)
    assert out["indexed"]["documents"] == len(mod.DOCUMENTS)
    assert len(out["chunks"]) == 2
    assert "HBM bandwidth" in out["chunks"][0]["text"]
    assert out["total_chars"] <= 800
    assert out["prompt"].startswith("Answer concisely.")
    assert "why is HBM bandwidth important" in out["prompt"]


def test_rest_and_sdk(tmp_path):
    out = example("rest_and_sdk").main(device="cpu", root=tmp_path)
    assert out["health"] in ("healthy", "degraded")
    assert out["count"] == 100
    assert out["top_hit"][0] == 7 and out["top_hit"][1] > 0.999
    assert out["batch_add"][0] == "completed"
    assert out["batch_add"][1]["added"] == 400
    assert out["semantic_hits"][0] == 300
    assert out["client_stats"]["errors"] == 0
    store = out["store"]
    assert len(store) == 500 and str(store.device) == "cpu"
    got = store.batch_query(out["vectors"][:4], k=1)
    assert [r[0][0] for r in got] == [0, 1, 2, 3]


def test_sharded_mesh(tmp_path):
    out = example("sharded_mesh").main(device="cpu", root=tmp_path)
    assert out["devices"] == ["cpu"] * 8
    assert out["stats"]["n_devices"] == 8
    assert out["stats"]["vector_count"] == 50_000
    assert out["agree"]
    for got, want in zip(out["sharded"], out["flat"]):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)


def test_examples_name_neither_jax_nor_the_jax_package():
    """No example's source imports jax or tpu_vector_db (only the port,
    ``tpu_vector_db_torch``)."""
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|tpu_vector_db)\b"
                            r"(?!_torch)", re.M)
    for name in NAMES:
        text = (EXAMPLES / f"torch_{name}.py").read_text()
        assert "tpu_vector_db_torch" in text
        assert not jax_import.search(text), name


def test_example_loads_no_jax(tmp_path):
    """In a fresh process, importing every example and running the
    quickstart on the CPU leaves neither jax nor tpu_vector_db in
    sys.modules."""
    code = (
        "import importlib.util, json, sys\n"
        f"names = {list(NAMES)!r}\n"
        "mods = {}\n"
        "for n in names:\n"
        f"    p = {str(EXAMPLES)!r} + f'/torch_{{n}}.py'\n"
        "    spec = importlib.util.spec_from_file_location(n, p)\n"
        "    mods[n] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mods[n])\n"
        f"mods['quickstart'].main(device='cpu', root={str(tmp_path)!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or\n"
        "    m.startswith('jax.') or m == 'tpu_vector_db' or\n"
        "    m.startswith('tpu_vector_db.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(tmp_path, name):
    """The default device is the card: with none, an example raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main(root=tmp_path)
