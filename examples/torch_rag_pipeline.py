#!/usr/bin/env python
"""RAG example: index documents, retrieve context, format a prompt.

The PyTorch port's version of ``examples/rag_pipeline.py``: the same
calls on ``tpu_vector_db_torch``, on the CUDA card unless ``--device
cpu`` (the encoder and the store both).

  python examples/torch_rag_pipeline.py [--device cpu] [--root DIR]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_vector_db_torch.pipeline import PipelineFactory  # noqa: E402

DOCUMENTS = [
    "TPUs accelerate machine learning with a systolic matrix unit (MXU). "
    "Feeding it large, batched bfloat16 matmuls is the key to performance. "
    "HBM bandwidth is usually the bottleneck for memory-bound kernels.",
    "A vector database stores embeddings and answers nearest-neighbor "
    "queries. Exact search scans every row; approximate indexes like "
    "navigable graphs trade a little recall for large speedups.",
    "Retrieval-augmented generation grounds a language model by fetching "
    "relevant chunks from an index and packing them into the prompt within "
    "a context budget.",
]


def main(device: str = "cuda", root=None, documents=DOCUMENTS) -> dict:
    """The RAG example on ``device``, its store under ``root`` (default:
    the system's temporary directory). Returns what it printed and the
    pipeline's store."""
    rag = PipelineFactory.create_rag_pipeline(
        Path(root or tempfile.gettempdir()) / "vdb_rag_example",
        model_name="hash-384",      # weights-free encoder; swap for a
        chunk_size=300,             # registry model with a local checkpoint
        device=device,
    )
    rag.pipeline.store.clear()

    stats = rag.index_documents(
        documents, [{"source": f"doc{i}"} for i in range(len(documents))])
    print("indexed:", stats)

    question = "why is HBM bandwidth important for TPU kernels?"
    ctx = rag.retrieve_context(question, k=2, max_context_chars=800)
    print(f"retrieved {len(ctx.chunks)} chunks ({ctx.total_chars} chars)")
    for c in ctx.chunks:
        print(f"  [{c['rank']}] sim={c['similarity']:.3f} "
              f"{c['text'][:60]}...")

    prompt = rag.format_rag_prompt(question, ctx,
                                   system_prompt="Answer concisely.")
    print("\n--- prompt ---\n" + prompt)
    return {"indexed": stats, "chunks": ctx.chunks,
            "total_chars": ctx.total_chars, "prompt": prompt,
            "store": rag.pipeline.store}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--root", default=None,
                    help="directory of the store (default: the system's "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device, root=args.root)
