#!/usr/bin/env python
"""Quickstart: the store as a library — create, add, query, filter, persist.

The PyTorch port's version of ``examples/quickstart.py``: the same calls
on ``tpu_vector_db_torch``, on the CUDA card unless ``--device cpu``.

  python examples/torch_quickstart.py [--device cpu] [--root DIR]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tpu_vector_db_torch as vdb  # noqa: E402


def main(device: str = "cuda", root=None, n: int = 1000,
         d: int = 384) -> dict:
    """The quickstart on ``device``, its store under ``root`` (default:
    the system's temporary directory). Returns what it printed and the
    store."""
    rng = np.random.default_rng(0)
    path = Path(root or tempfile.gettempdir()) / "vdb_quickstart"

    # 1. create a store (cosine, 384-D, bf16 storage on device)
    store = vdb.create_vector_store(
        path, dimension=d, metric="cosine", storage_dtype="bfloat16",
        device=device)
    store.clear()

    # 2. add vectors with metadata
    docs = rng.standard_normal((n, d)).astype(np.float32)
    store.add_vectors(docs, [
        {"doc_id": f"doc_{i}", "lang": "en" if i % 2 else "de"}
        for i in range(n)
    ])
    print(f"store holds {len(store)} vectors")

    # 3. query (top-k nearest by cosine similarity)
    indices, scores, metadata = store.query(docs[42], k=3)
    self_query = (indices, scores)
    print("self-query:", list(zip(indices, [round(s, 4) for s in scores])))

    # 4. filtered query — exact-match metadata subset
    indices, scores, metadata = store.query(
        docs[42], k=3, filter_metadata={"lang": "de"})
    filtered = (indices, scores, [m["lang"] for m in metadata])
    print("filtered:", [(i, m["lang"]) for i, m in zip(indices, metadata)])

    # 5. batched queries (one device sweep for the whole batch)
    results = store.batch_query(docs[:8], k=2)
    print("batch top-1s:", [r[0][0] for r in results])

    # 6. persistence: stores reload from disk
    store.flush()
    # config=None restores the persisted config from manifest.json (the
    # created-with dtype/metric/ANN settings); passing a mismatching
    # config would raise StoreDimensionMismatch by design
    reloaded = vdb.TorchVectorStore(path, device=device)
    reloaded_top1 = reloaded.query(docs[42], k=1)[0]
    parity = reloaded_top1 == indices[:1] or reloaded_top1 == [42]
    print(f"reloaded {len(reloaded)} vectors;", "query parity:", parity)

    stats = store.get_stats()
    print("stats:", stats)
    return {"count": len(store), "self_query": self_query,
            "filtered": filtered, "batch": results,
            "reloaded_count": len(reloaded), "reloaded_top1": reloaded_top1,
            "parity": parity, "stats": stats, "store": store}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--root", default=None,
                    help="directory of the store (default: the system's "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root)
