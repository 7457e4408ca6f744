#!/usr/bin/env python
"""Sharded store over a device mesh: rows split over the devices, a local
top-k on each, one merge.

The PyTorch port's version of ``examples/sharded_mesh.py``. Where the
JAX script forces 8 virtual CPU devices, this one puts 8 co-located
shards on one device (``--device``, the CUDA card by default: eight
scans and one k·P merge a call), or one shard on every visible card
with ``--all-cards``. The same code drives either.

  python examples/torch_sharded_mesh.py [--device cpu] [--all-cards]
                                        [--root DIR]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_vector_db_torch.parallel import (  # noqa: E402
    ShardedVectorStore, make_device_mesh)
from tpu_vector_db_torch.store import (  # noqa: E402
    TorchVectorStore, VectorStoreConfig)


def main(device: str = "cuda", root=None, all_cards: bool = False,
         shards: int = 8, n: int = 50_000, d: int = 64,
         queries: int = 4) -> dict:
    """The sharded store on ``shards`` co-located shards of ``device``
    (``all_cards``: one shard a visible card) beside a single-device
    store on the same rows, under ``root`` (default: the system's
    temporary directory). Returns what it printed and both stores."""
    mesh = (make_device_mesh() if all_cards
            else make_device_mesh(devices=[device] * shards))
    print(f"mesh: {mesh.size} devices, axes {mesh.axis_names}")

    rng = np.random.default_rng(0)
    base = Path(root or tempfile.gettempdir())
    cfg = dict(dimension=d, block_rows=1024, persist_mode="off")
    sharded = ShardedVectorStore(base / "vdb_shard_example",
                                 VectorStoreConfig(**cfg), mesh=mesh)
    sharded.clear()

    vectors = rng.standard_normal((n, d)).astype(np.float32)
    sharded.add_vectors(vectors, [{"i": i} for i in range(len(vectors))])
    stats = sharded.get_stats()
    print("sharded stats:", stats)

    # identical results to a single-device store
    flat = TorchVectorStore(base / "vdb_flat_example",
                            VectorStoreConfig(**cfg), device=mesh.lead)
    flat.clear()
    flat.add_vectors(vectors)

    qs = rng.standard_normal((queries, d)).astype(np.float32)
    rs = sharded.batch_query(qs, k=5)
    rf = flat.batch_query(qs, k=5)
    agree = all(a[0] == b[0] for a, b in zip(rs, rf))
    print("sharded == flat results:", agree)
    print("top-5 for query 0:", rs[0][0])
    return {"devices": [str(x) for x in mesh.devices], "stats": stats,
            "queries": qs, "sharded": rs, "flat": rf, "agree": agree,
            "store": sharded, "flat_store": flat}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--all-cards", action="store_true",
                    help="one shard on every visible card instead of 8 "
                         "shards on --device")
    ap.add_argument("--root", default=None,
                    help="directory of the stores (default: the system's "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root, all_cards=args.all_cards)
