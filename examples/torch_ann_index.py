#!/usr/bin/env python
"""ANN example: beam-graph index, recall vs exact search, incremental adds.

The PyTorch port's version of ``examples/ann_index.py``: the same calls
on ``tpu_vector_db_torch``, on the CUDA card unless ``--device cpu``.

  python examples/torch_ann_index.py [--device cpu] [--root DIR]
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_vector_db_torch.store import (  # noqa: E402
    TorchVectorStore, VectorStoreConfig)


def main(device: str = "cuda", root=None, n: int = 20_000, d: int = 128,
         centres: int = 200, queries: int = 50, extra: int = 1000) -> dict:
    """The ANN example on ``device``, its store under ``root`` (default:
    the system's temporary directory). Returns what it printed and the
    store."""
    rng = np.random.default_rng(0)
    store = TorchVectorStore(
        Path(root or tempfile.gettempdir()) / "vdb_ann_example",
        VectorStoreConfig(
            dimension=d,
            enable_ann=True,
            persist_mode="off",
            # hnswlib-compatible knobs; build_backend: "tpu" (the store's
            # device) | "cpu" (native C++). index_type pins the graph
            # family — the 'auto' default would route this 20K-row demo
            # to the exact flat scan
            ann_params={"index_type": "beam_graph", "min_rows": 0,
                        "M": 16, "ef_construction": 200, "ef_search": 100,
                        "build_backend": "auto"},
        ), device=device)
    store.clear()

    # clustered data, like real embedding distributions (uniform random
    # vectors are the adversarial regime for every graph index — see
    # BENCHMARKS.md)
    mu = rng.standard_normal((centres, d)).astype(np.float32) * 3
    vectors = (mu[rng.integers(0, centres, n)] +
               rng.standard_normal((n, d))).astype(np.float32)
    t0 = time.time()
    store.add_vectors(vectors)
    index_stats = store._ann.get_stats()
    print(f"ingest+index {n // 1000}K: {time.time() - t0:.1f}s "
          f"(index: {index_stats})")

    qs = (mu[rng.integers(0, centres, queries)] +
          rng.standard_normal((queries, d))).astype(np.float32)
    hits = misses = 0
    for q in qs:
        ann_ids, _, _ = store.query(q, k=10)                 # beam graph
        exact_ids, _, _ = store.query(q, k=10, use_ann=False)  # flat scan
        hits += len(set(ann_ids) & set(exact_ids))
        misses += len(set(exact_ids) - set(ann_ids))
    recall = hits / (hits + misses)
    print(f"recall@10 vs exact: {recall:.3f}")

    # incremental add: extends the graph, no full rebuild
    more = rng.standard_normal((extra, d)).astype(np.float32)
    t0 = time.time()
    store.add_vectors(more)
    print(f"incremental add of {extra // 1000}K: {time.time() - t0:.1f}s "
          f"(graph now {store._ann.size} nodes)")
    ids, _, _ = store.query(more[0], k=1)
    reachable = ids == [n]
    print("new vector reachable:", reachable)
    return {"index": index_stats, "recall": recall,
            "graph_nodes": store._ann.size, "reachable": reachable,
            "store": store}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--root", default=None,
                    help="directory of the store (default: the system's "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root)
