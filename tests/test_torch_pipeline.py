"""The port's text / RAG pipeline against the JAX package's.

- ``chunk_text`` equal on random texts.
- One RAG sequence on both packages (index documents, retrieve context
  at k 2 and 5, search at k 40, a filter floor, a length budget, the
  prompt): the same chunk ids (doc_id, chunk_id and the store's row) and
  similarities within 1e-5 (float32 embeddings within 1e-5, then the
  scan's float32 sums in another order), with ``hash-384`` and with a
  tiny BERT checkpoint (float32).
- A store indexed and flushed by the JAX pipeline, queried by the
  port's, and the reverse: the on-disk format is shared, so each answers
  the other's queries as its own.
- The JAX test_pipeline.py cases, on the port.
"""

import random

import numpy as np
import pytest
import torch

from test_torch_bert import make_bert_dir

SIM_TOL = 1e-5

DOCS = [
    "The TPU is an accelerator for machine learning workloads. "
    "It excels at large matrix multiplications in bfloat16. "
    "The MXU systolic array performs the bulk of the FLOPs.",
    "Vector databases store embeddings and answer nearest-neighbor "
    "queries. Recall at k measures the fraction of true neighbors found. "
    "HNSW is a popular graph index for approximate search.",
    "Cooking pasta requires boiling salted water. "
    "Add the pasta and stir occasionally until al dente. "
    "Reserve some pasta water for the sauce.",
    "The quick brown fox jumps over the lazy dog. " * 12,
    "Hello world! Unbelievable runners run. Temperature data search. " * 6,
]

QUERIES = ["how does the TPU do matrix math", "vector database recall",
           "boiling pasta water", "quick fox", "hello temperature search"]


def random_text(rng: random.Random) -> str:
    words = ["alpha", "beta", "gamma", "delta", "x", "quick", "fox"]
    parts = []
    for _ in range(rng.randint(0, 120)):
        parts.append(rng.choice(words))
        if rng.random() < 0.15:
            parts.append(rng.choice([".", "!", "?", ". ", "! ", "\n"]))
    return " ".join(parts)


@pytest.mark.parametrize("seed", range(4))
def test_chunk_text_equal_jax(seed):
    from tpu_vector_db.pipeline.pipeline import chunk_text as jchunk
    from tpu_vector_db_torch.pipeline import chunk_text
    rng = random.Random(seed)
    for _ in range(100):
        text = random_text(rng)
        size, overlap = rng.choice([(20, 5), (64, 10), (120, 30), (512, 50),
                                    (100, 99)])
        assert chunk_text(text, size, overlap) == jchunk(text, size,
                                                         overlap), text


def rag_pair(tmp_path, model_name, **rag):
    from tpu_vector_db.pipeline import PipelineFactory as J
    from tpu_vector_db_torch.pipeline import PipelineFactory
    return (J.create_rag_pipeline(tmp_path / "jax", model_name=model_name,
                                  **rag),
            PipelineFactory.create_rag_pipeline(
                tmp_path / "port", model_name=model_name, device="cpu",
                **rag))


def same_hits(got: list[dict], want: list[dict]) -> None:
    assert [(h["index"], h["metadata"].get("doc_id"),
             h["metadata"].get("chunk_id")) for h in got] == \
        [(h["index"], h["metadata"].get("doc_id"),
          h["metadata"].get("chunk_id")) for h in want]
    np.testing.assert_allclose([h["similarity"] for h in got],
                               [h["similarity"] for h in want],
                               atol=SIM_TOL, rtol=0)
    assert [h["text"] for h in got] == [h["text"] for h in want]


def run_sequence(jrag, rag) -> None:
    meta = [{"title": f"d{i}"} for i in range(len(DOCS))]
    out_j, out_p = jrag.index_documents(DOCS, meta), rag.index_documents(
        DOCS, meta)
    assert out_p["chunks"] == out_j["chunks"] > len(DOCS)
    for q in QUERIES:
        for k in (2, 5):
            ctx_j = jrag.retrieve_context(q, k=k)
            ctx_p = rag.retrieve_context(q, k=k)
            same_hits(ctx_p.chunks, ctx_j.chunks)
            assert ctx_p.total_chars == ctx_j.total_chars
            assert rag.format_rag_prompt(q, ctx_p, "Be brief.") == \
                jrag.format_rag_prompt(q, ctx_j, "Be brief.")
        same_hits(rag.pipeline.search_similar_texts(q, k=40),
                  jrag.pipeline.search_similar_texts(q, k=40))
        ctx = rag.retrieve_context(q, k=5, max_context_chars=150)
        assert ctx.total_chars == jrag.retrieve_context(
            q, k=5, max_context_chars=150).total_chars <= 150
        same_hits(rag.retrieve_context(q, k=3, min_similarity=0.3).chunks,
                  jrag.retrieve_context(q, k=3, min_similarity=0.3).chunks)


def test_rag_sequence_hash_equal_jax(tmp_path):
    run_sequence(*rag_pair(tmp_path, "hash-384", chunk_size=120,
                           chunk_overlap=20))


def test_rag_sequence_bert_equal_jax(tmp_path):
    d = make_bert_dir(tmp_path / "ckpt")
    from tpu_vector_db.pipeline import RAGPipeline as JRAG
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db.store import TPUVectorStore
    from tpu_vector_db.store import VectorStoreConfig as JCfg
    from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
    from tpu_vector_db_torch.pipeline import RAGPipeline
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    jenc = jcreate(f"hf:{d}", dtype="float32")
    enc = create_encoder(f"hf:{d}", device="cpu", dtype="float32")
    jenc.load()
    enc.load()
    jrag = JRAG(jenc, TPUVectorStore(tmp_path / "j", JCfg(
        dimension=32, persist_mode="off")), chunk_size=120, chunk_overlap=20)
    rag = RAGPipeline(enc, TorchVectorStore(tmp_path / "p", VectorStoreConfig(
        dimension=32, persist_mode="off"), device="cpu"), chunk_size=120,
        chunk_overlap=20)
    run_sequence(jrag, rag)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_queried_by_other(tmp_path, writer):
    """create_rag_pipeline's lazy store, indexed and flushed by one
    package, reopened and queried through the other's pipeline."""
    from tpu_vector_db.pipeline import PipelineFactory as J
    from tpu_vector_db.pipeline import RAGPipeline as JRAG
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db.store import TPUVectorStore
    from tpu_vector_db_torch import TorchVectorStore
    from tpu_vector_db_torch.pipeline import PipelineFactory, RAGPipeline
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    path = tmp_path / "store"
    if writer == "jax":
        first = J.create_rag_pipeline(path, model_name="hash-384",
                                      chunk_size=120, chunk_overlap=20)
    else:
        first = PipelineFactory.create_rag_pipeline(
            path, model_name="hash-384", device="cpu", chunk_size=120,
            chunk_overlap=20)
    first.index_documents(DOCS)
    first.pipeline.store.flush()
    want = {q: first.retrieve_context(q, k=5).chunks for q in QUERIES}
    if writer == "jax":
        other = RAGPipeline(create_encoder("hash-384", device="cpu"),
                            TorchVectorStore(path, device="cpu"))
    else:
        other = JRAG(jcreate("hash-384"), TPUVectorStore(path))
    for q in QUERIES:
        same_hits(other.retrieve_context(q, k=5).chunks, want[q])


def test_create_rag_pipeline_runs_on_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from tpu_vector_db_torch.pipeline import PipelineFactory
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineFactory.create_rag_pipeline(tmp_path / "rag",
                                            model_name="hash-256")


def test_create_rag_pipeline_sizes_store_after_load(tmp_path):
    """An hf:<dir> encoder serves its checkpoint's hidden size (32, not
    the config's 384): the store is sized after load(), lazy."""
    from tpu_vector_db_torch.pipeline import PipelineFactory
    d = make_bert_dir(tmp_path / "ckpt")
    rag = PipelineFactory.create_rag_pipeline(
        tmp_path / "rag", model_name=f"hf:{d}", device="cpu")
    store = rag.pipeline.store
    assert store.config.dimension == 32
    assert store.config.persist_mode == "lazy"
    assert str(store.device) == "cpu"
    assert rag.index_documents(["the quick brown fox."])["chunks"] == 1


# ---------------------------------------- tests/test_pipeline.py, on the port

def port_store(tmp_path, dim=384):
    from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
    return TorchVectorStore(tmp_path / "s", VectorStoreConfig(
        dimension=dim, persist_mode="off"), device="cpu")


def test_dimension_mismatch_raises(tmp_path):
    from tpu_vector_db_torch.pipeline import EmbeddingPipeline, create_encoder
    with pytest.raises(ValueError):
        EmbeddingPipeline(create_encoder("hash-256", device="cpu"),
                          port_store(tmp_path))


def test_process_and_search(tmp_path):
    from tpu_vector_db_torch.pipeline import EmbeddingPipeline, create_encoder
    pipe = EmbeddingPipeline(create_encoder("hash-384", device="cpu"),
                             port_store(tmp_path))
    out = pipe.process_texts(DOCS[:3], [{"src": i} for i in range(3)])
    assert out["texts_processed"] == 3
    hits = pipe.search_similar_texts("nearest neighbor vector recall", k=2)
    assert hits[0]["text"].startswith("Vector databases")
    assert hits[0]["similarity"] >= hits[1]["similarity"]
    assert hits[0]["metadata"]["src"] == 1
    assert "pasta" in pipe.search_similar_texts("boiling pasta water",
                                                k=1)[0]["text"]
    with pytest.raises(ValueError, match="metadata"):
        pipe.process_texts(["a", "b"], [{}])
    stats = pipe.get_stats()
    assert stats["texts_indexed"] == 3 and stats["searches"] == 2


def test_index_retrieve_and_prompt(tmp_path):
    from tpu_vector_db_torch.pipeline import RAGPipeline, create_encoder
    rag = RAGPipeline(create_encoder("hash-384", device="cpu"),
                      port_store(tmp_path), chunk_size=200,
                      chunk_overlap=20)
    out = rag.index_documents(DOCS[:3], [{"title": f"d{i}"}
                                         for i in range(3)])
    assert out["documents"] == 3 and out["chunks"] >= 3
    ctx = rag.retrieve_context("how does the TPU do matrix math", k=2)
    assert "TPU" in ctx.chunks[0]["text"] or "MXU" in ctx.chunks[0]["text"]
    prompt = rag.format_rag_prompt("how does the TPU work?", ctx,
                                   system_prompt="Be brief.")
    assert prompt.startswith("Be brief.")
    assert "[1]" in prompt and "Question:" in prompt
    assert rag.retrieve_context("zzz qqq completely unrelated gibberish",
                                k=3, min_similarity=0.9).chunks == []


def test_recommendation_equals_jax():
    from tpu_vector_db.pipeline import PipelineFactory as J
    from tpu_vector_db_torch.pipeline import PipelineFactory
    for use_case in ("general", "retrieval", "quality", "multilingual",
                     "ci", "unknown"):
        for budget in (None, 0, 100, 500, 2000):
            assert PipelineFactory.recommend_model(use_case, budget) == \
                J.recommend_model(use_case, budget)
