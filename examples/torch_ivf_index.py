#!/usr/bin/env python
"""IVF example: k-means coarse quantizer + bucket-streamed probe scan.

The PyTorch port's version of ``examples/ivf_index.py``: the same calls
on ``tpu_vector_db_torch``, on the CUDA card unless ``--device cpu``.
There an IVF query is one launch of the probe kernel
(``csrc/ivf_topk.cu``) over the buckets its centroids select. Recall is a
coverage knob: every probed bucket gets exact scores, so more nprobe =
more recall, linearly more scan.

  python examples/torch_ivf_index.py [--device cpu] [--root DIR]
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


def main(device: str = "cuda", root=None, n: int = 50_000, d: int = 128,
         centres: int = 64, queries: int = 100, extra: int = 500) -> dict:
    """The IVF example on ``device``, its store under ``root`` (default:
    the system's temporary directory). Returns what it printed, the
    answers of both engines and the store."""
    rng = np.random.default_rng(0)
    store = TorchVectorStore(
        Path(root or tempfile.gettempdir()) / "vdb_ivf_example",
        VectorStoreConfig(
            dimension=d,
            enable_ann=True,
            persist_mode="off",
            ann_params={
                "index_type": "ivf",   # selects the IVF family
                "nprobe": 32,          # buckets scanned per query
                "min_rows": 10_000,    # flat scan below this size
                # "n_clusters": ...,   # default: max(2*sqrt(N), N/1024)
            },
        ), device=device)
    store.clear()

    # clustered data — the regime ANN indexes exist for
    mu = rng.standard_normal((centres, d)).astype(np.float32) * 3
    x = (mu[rng.integers(0, centres, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    t0 = time.perf_counter()
    store.add_vectors(x, [{"i": i} for i in range(n)])
    store.optimize()  # builds the quantizer now instead of first query
    index_type = store.get_stats()["index_type"]
    print(f"ingest+build: {time.perf_counter() - t0:.1f}s "
          f"(index_type={index_type})")

    # recall vs the exact engine on held-out-style queries
    q = x[:queries] + 0.1 * rng.standard_normal((queries, d)).astype(
        np.float32)
    hits = 0
    ivf, exact = [], []
    t0 = time.perf_counter()
    for i in range(queries):
        ivf_ids, ivf_scores, _ = store.query(q[i], k=10)     # IVF route
        exact_ids, exact_scores, _ = store.query(q[i], k=10, use_ann=False)
        hits += len(set(ivf_ids) & set(exact_ids))
        ivf.append((ivf_ids, ivf_scores))
        exact.append((exact_ids, exact_scores))
    recall = hits / (10 * queries)
    print(f"recall@10 vs exact: {recall:.3f} "
          f"({(time.perf_counter() - t0) * 1e3 / (2 * queries):.1f} "
          "ms/query pair)")

    # incremental adds assign to existing centroids — O(batch), no retrain
    t0 = time.perf_counter()
    store.add_vectors(x[:extra] + 0.01)
    print(f"incremental add of {extra}: {time.perf_counter() - t0:.2f}s")
    return {"index_type": index_type, "recall": recall, "queries": q,
            "ivf": ivf, "exact": exact, "count": len(store),
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
