#!/usr/bin/env python
"""Capacity modes: int8/int4 quantized vector storage + gather-layout IVF.

The PyTorch port's version of ``examples/capacity_mode.py``: the same
calls on ``tpu_vector_db_torch``, on the CUDA card unless ``--device
cpu``. storage_dtype="int8" holds twice the rows of bf16 (unit-norm rows
quantized to a fixed x127 scale) and "int4" twice that again (two
offset-8 nibbles per byte, one f32 scale per row chosen so the
dequantized row is exactly unit-norm). The exact scan kernel
(``csrc/flat_topk.cu``) scores the quantized rows directly — keys are
the true cosine of the stored point.

With enable_ann=True the store builds a GATHER-layout IVF on top: the
index holds only a ~4 B/row id table and probes gather their rows from
the flat matrix (``index/ivf.py``; on the card the kernel
``ivf_gather_kernel`` in ``csrc/ivf_topk.cu``).

  python examples/torch_capacity_mode.py [--device cpu] [--root DIR]
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


def main(device: str = "cuda", root=None, n: int = 50_000,
         d: int = 256) -> dict:
    """Both capacity modes on ``device``, their stores under ``root``
    (default: the system's temporary directory). Returns, by dtype, what
    it printed, both engines' answers and the store."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)

    out = {}
    for dtype in ("int8", "int4"):
        store = TorchVectorStore(
            Path(root or tempfile.gettempdir()) / f"vdb_capacity_{dtype}",
            VectorStoreConfig(
                dimension=d,
                storage_dtype=dtype,          # cosine-only capacity mode
                enable_ann=True,              # gather-layout IVF on top
                persist_mode="off",
                # index_type='auto' would route this small demo corpus to
                # the exact scan (it is under the 100K flat crossover);
                # real capacity-scale stores resolve to IVF automatically
                ann_params={"index_type": "ivf", "nprobe": 16,
                            "self_check": False}), device=device)
        t0 = time.perf_counter()
        store.add_vectors(x, [{"i": i} for i in range(n)])
        index_type = store.get_stats()["index_type"]
        print(f"[{dtype}] ingested {n} rows in "
              f"{time.perf_counter() - t0:.1f}s; index = {index_type}")

        q = x[123]
        t0 = time.perf_counter()
        ids, scores, _ = store.query(q, k=5)
        st = store._ann.get_stats()
        print(f"[{dtype}] self-query top-1 id={ids[0]} "
              f"score={scores[0]:.4f} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call "
              f"compiles); {st['layout']} layout, "
              f"{st['memory_mb']} MB index overhead")
        assert scores[0] > 0.95

        # exact engine on the same quantized rows for comparison
        exact = store.batch_query(q[None], k=5, use_ann=False)[0]
        print(f"[{dtype}] exact-engine top-1 score={exact[1][0]:.4f} "
              f"(same quantized rows — IVF recall is a coverage knob)")
        out[dtype] = {"index_type": index_type, "layout": st["layout"],
                      "ivf": (ids, scores), "exact": exact[:2],
                      "store": store}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--root", default=None,
                    help="directory of the stores (default: the system's "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root)
