"""How the port's stores resolve ``ann_params``: the store-level defaults
of ``store/config.py``, the index classes' own construction defaults, and
the default dict a manifest holds."""

import json

import numpy as np
import pytest

from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex
from tpu_vector_db_torch.index.ivf import IVFIndex
from tpu_vector_db_torch.parallel import ShardedVectorStore, make_device_mesh
from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
from tpu_vector_db_torch.store import persistence
from tpu_vector_db_torch.store.config import (ANN_DEFAULTS, VectorStoreConfig,
                                              ann_param)
from tpu_vector_db_torch.store.vector_store import TorchVectorStore

# the defaults as the stores wrote them out before they had one table
FROZEN = {
    "index_type": "auto",
    "ef_search": 100,
    "rerank_oversample": 4,
    "auto_flat_rows": 100_000,
    "ann_min_rows": 0,
    "auto_batch_flat_q": 32,
    "auto_batch_flat_rows": 2_000_000,
    "filter_exact_selectivity": 0.05,
    "deleted_exact_live_frac": 0.25,
    "build_backend": "tpu",
    "self_check": True,
    "remediate_target": 0.98,
    "auto_remediate": True,
    "remediate_max_refines": 2,
    "recall_warn": 0.90,
    "recall_floor": 0.50,
    "ivf_gather_large_k": False,
}

IVF_FIELDS = ("nprobe", "n_clusters", "bucket_rows", "train_iters")
GRAPH_FIELDS = ("M", "ef_construction", "alpha")


def test_the_table_holds_every_store_level_key():
    assert ANN_DEFAULTS.keys() == FROZEN.keys()


@pytest.mark.parametrize("key", sorted(FROZEN))
def test_each_key_defaults_as_before(key):
    got = ann_param({}, key)
    assert got == FROZEN[key] and type(got) is type(FROZEN[key])
    assert ann_param({key: "set"}, key) == "set"


def test_ann_min_rows_falls_back_to_min_rows():
    assert ann_param({"min_rows": 7}, "ann_min_rows") == 7
    assert ann_param({"min_rows": 7, "ann_min_rows": 3},
                     "ann_min_rows") == 3


def _single(tmp_path, params) -> TorchVectorStore:
    return TorchVectorStore(
        tmp_path / "single", VectorStoreConfig(
            dimension=8, enable_ann=True, persist_mode="off",
            ann_params=dict(params)), device="cpu")


def _sharded_index(tmp_path, params, monkeypatch):
    """The index a one-shard sharded store makes from ``params``, with its
    sidecar load and its build stubbed out."""
    store = ShardedVectorStore(
        tmp_path / "sharded", VectorStoreConfig(
            dimension=8, enable_ann=True, persist_mode="off",
            ann_params=dict(params)), mesh=make_device_mesh(devices=["cpu"]))
    for cls in (ShardedIVF, ShardedBeamGraph):
        monkeypatch.setattr(cls, "load", lambda self, *a: False)
        monkeypatch.setattr(cls, "build", lambda self, *a: None)
    if params["index_type"] == "ivf":
        store._refresh_sharded_ivf(None)
    else:
        store._refresh_sharded_graph(None)
    return store._ann


@pytest.mark.parametrize("params,want", [
    ({"index_type": "ivf"}, (32, None, None, 10)),
    ({"index_type": "ivf", "nprobe": 7, "n_clusters": 12,
      "bucket_rows": 64, "train_iters": 3}, (7, 12, 64, 3)),
    ({"index_type": "beam_graph"}, (16, 200, 1.2)),
    ({"index_type": "beam_graph", "M": 8, "ef_construction": 40,
      "alpha": 1.1}, (8, 40, 1.1)),
], ids=["ivf-empty", "ivf-every-key", "graph-empty", "graph-every-key"])
def test_single_and_sharded_stores_construct_the_same_index(
        tmp_path, monkeypatch, params, want):
    fields = IVF_FIELDS if params["index_type"] == "ivf" else GRAPH_FIELDS
    single = _single(tmp_path, params)._make_ann()
    sharded = _sharded_index(tmp_path, params, monkeypatch)
    assert isinstance(single, IVFIndex if params["index_type"] == "ivf"
                      else BeamGraphIndex)
    assert tuple(getattr(single, f) for f in fields) == want
    assert tuple(getattr(sharded, f) for f in fields) == want


def test_single_store_passes_the_graph_and_ivf_only_keys(tmp_path):
    graph = _single(tmp_path, {
        "index_type": "beam_graph", "entry_cap": 2048,
        "insert_budget_div": 2, "refine_budget_div": 3})._make_ann()
    assert (graph.entry_cap, graph.insert_budget_div,
            graph.refine_budget_div) == (2048, 2, 3)
    default = _single(tmp_path, {"index_type": "beam_graph"})._make_ann()
    assert (default.entry_cap, default.insert_budget_div,
            default.refine_budget_div) == (4096, 3, 2)
    assert _single(tmp_path, {"index_type": "ivf", "ivf_layout": "gather"}
                   )._make_ann().layout_mode == "gather"
    assert _single(tmp_path, {"index_type": "ivf"}
                   )._make_ann().layout_mode == "auto"


def test_default_manifest_keeps_three_keys_and_reopens_alike(tmp_path):
    path = tmp_path / "store"
    store = TorchVectorStore(path, VectorStoreConfig(dimension=8),
                             device="cpu")
    store.add_vectors(np.eye(8, dtype=np.float32))
    store.close()
    manifest = json.loads((path / persistence.MANIFEST_FILE).read_text())
    assert json.dumps(manifest["config"]["ann_params"]) == \
        '{"M": 16, "ef_construction": 200, "ef_search": 100}'
    reopened = TorchVectorStore(path, device="cpu")
    params = reopened.config.ann_params
    assert params == {"M": 16, "ef_construction": 200, "ef_search": 100}
    for key, value in FROZEN.items():
        assert ann_param(params, key) == value, key
    graph = _single(tmp_path, {**params, "index_type": "beam_graph"}
                    )._make_ann()
    assert tuple(getattr(graph, f) for f in GRAPH_FIELDS) == (16, 200, 1.2)


def test_graph_budget_counts_the_graphs_default_degree():
    """f32 rows padded to 128 columns, and 2M edges of 8 bytes a row."""
    cfg = VectorStoreConfig(dimension=8, enable_ann=True,
                            ann_params={"index_type": "beam_graph"})
    assert cfg.device_bytes_for(1) == 4 * 128 + 16 * 2 * 8
