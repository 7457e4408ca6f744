"""Worker process of tests/test_torch_multihost.py: one of two processes
that join a gloo process group through the port's
``parallel/mesh.bootstrap_distributed`` and hold 2 CPU shards each of a
4-shard mesh.

    python _torch_multihost_worker.py MODE COORDINATOR RANK IN.npz OUT.npz

MODE ``mesh``: a cross-process all-gather, then the sharded flat scan
over rows that live on both processes (``make_sharded_query_fn`` on the
process's own shards), once per case in IN.npz; the answers go to
OUT.npz. MODE ``ann``: a sharded IVF store and a sharded beam-graph store
(``ShardedVectorStore`` over the 2 x 2 mesh) filled, queried and flushed
under IN.npz's ``dir``; the answers go to OUT.npz. MODE ``mismatch``:
this process brings 1 + RANK shards, so making the mesh must raise.

The worker imports no JAX: the parent computes the references.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpu_vector_db_torch.parallel import mesh as pmesh  # noqa: E402

torch.set_num_threads(1)
LOCAL = 2


def local_shards(mesh, x: np.ndarray) -> list:
    """This process's shards of ``x``'s rows (P equal parts)."""
    rows = x.shape[0] // mesh.n_shards
    return [torch.from_numpy(np.ascontiguousarray(
        x[(mesh.first_shard + s) * rows:(mesh.first_shard + s + 1) * rows]))
        for s in range(mesh.size)]


def run_mesh(mesh, data, out: dict) -> None:
    from tpu_vector_db_torch.parallel.sharded_scan import (
        make_sharded_query_fn)
    gathered = [torch.zeros(LOCAL) for _ in range(mesh.process_count)]
    dist.all_gather(gathered, torch.full((LOCAL,),
                                         float(mesh.process_index + 1)))
    out["all_gather_sum"] = np.float32(sum(float(t.sum()) for t in gathered))
    db = local_shards(mesh, data["db"])
    mask = local_shards(mesh, data["mask"])
    q = torch.from_numpy(data["queries"])
    for i, (k, count) in enumerate(data["cases"]):
        fn, _ = make_sharded_query_fn(mesh, int(k), with_filter=True)
        keys, ids = fn(q, db, int(count), mask)
        out[f"keys_{i}"], out[f"ids_{i}"] = keys.numpy(), ids.numpy()


def run_ann(mesh, data, out: dict) -> None:
    from pathlib import Path

    from tpu_vector_db_torch.parallel import ShardedVectorStore
    from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
    from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
    from tpu_vector_db_torch.store.config import VectorStoreConfig
    rows, qs = data["rows"], data["queries"]
    base = Path(str(data["dir"])) / f"rank{mesh.process_index}"
    for kind, cls, params in (
            ("ivf", ShardedIVF, {"index_type": "ivf", "nprobe": 8}),
            ("beam_graph", ShardedBeamGraph,
             {"index_type": "beam_graph", "ef_search": 64, "M": 8,
              "ef_construction": 64})):
        store = ShardedVectorStore(base / kind, VectorStoreConfig(
            dimension=rows.shape[1], persist_mode="lazy", enable_ann=True,
            ann_params=params), mesh=mesh)
        half = rows.shape[0] // 2
        store.add_vectors(rows[:half])
        store.add_vectors(rows[half:])
        assert isinstance(store._ann, cls), type(store._ann)
        ids, keys = store._ann_search(store._prepare_queries(qs), 10)
        out[f"{kind}_ids"], out[f"{kind}_keys"] = ids, keys
        res = store.batch_query(qs, k=10)
        out[f"{kind}_query_ids"] = np.array([r[0] for r in res])
        store.flush()


def main() -> None:
    mode, coordinator, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    assert pmesh.bootstrap_distributed(coordinator, 2, rank, timeout_s=120)
    assert (pmesh.process_index(), pmesh.process_count()) == (rank, 2)
    if mode == "mismatch":
        try:
            pmesh.make_device_mesh(devices=["cpu"] * (1 + rank))
        except ValueError as exc:
            assert "as many shards" in str(exc), exc
            print(f"MISMATCH_RAISES process={rank}", flush=True)
    else:
        mesh = pmesh.make_device_mesh(devices=["cpu"] * LOCAL)
        assert (mesh.n_shards, mesh.first_shard, mesh.size) == (
            2 * LOCAL, rank * LOCAL, LOCAL), mesh
        data = dict(np.load(sys.argv[4]))
        out: dict = {}
        {"mesh": run_mesh, "ann": run_ann}[mode](mesh, data, out)
        np.savez(sys.argv[5], **out)
    dist.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MULTIHOST_OK process={rank} jax_loaded=False", flush=True)


if __name__ == "__main__":
    main()
