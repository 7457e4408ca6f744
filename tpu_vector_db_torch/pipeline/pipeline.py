"""Text pipeline + RAG over a vector store.

Counterpart of ``tpu_vector_db/pipeline/pipeline.py`` over
``TorchVectorStore``: dimension check against the store, process_texts
(batched encode -> add_vectors), search_similar_texts (encode -> query ->
ranked results with score conversion), RAG index_documents with an
overlapping sentence-boundary-aware chunker, retrieve_context with
over-fetch + min-similarity + context length budget, format_rag_prompt,
and a factory with use-case/memory-budget model recommendation. The
factory's store is a default-config store (exact search, ``lazy``
persistence), so every retrieval is the flat scan: ``scan_kernel`` for
``retrieve_context(k <= 16)`` (it fetches 2k), ``scan_kernel_bigk`` past
k = 32.
"""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING

from tpu_vector_db_torch.ops.distance import raw_score_to_similarity_distance
from tpu_vector_db_torch.pipeline.encoders import (
    EMBEDDING_MODEL_REGISTRY, BaseEncoder, create_encoder)
from tpu_vector_db_torch.store.config import VectorStoreConfig

if TYPE_CHECKING:
    from tpu_vector_db_torch.store.vector_store import TorchVectorStore

logger = logging.getLogger(__name__)

_SENTENCE_END = re.compile(r"[.!?]\s")


def chunk_text(text: str, chunk_size: int = 512,
               overlap: int = 50) -> list[str]:
    """Overlapping chunks that prefer to break at a sentence boundary in the
    last 30% of the window (a copy of the JAX package's)."""
    if len(text) <= chunk_size:
        return [text] if text.strip() else []
    chunks = []
    start = 0
    while start < len(text):
        end = min(start + chunk_size, len(text))
        window = text[start:end]
        if end < len(text):
            cut = None
            for m in _SENTENCE_END.finditer(window):
                if m.end() >= chunk_size * 0.7:
                    cut = m.end()
            if cut is not None:
                end = start + cut
                window = text[start:end]
        if window.strip():
            chunks.append(window.strip())
        if end >= len(text):
            break
        start = max(end - overlap, start + 1)
    return chunks


class EmbeddingPipeline:
    """Encoder + store: text in, vectors stored, text out ranked."""

    def __init__(self, encoder: BaseEncoder, store: TorchVectorStore,
                 batch_size: int = 32) -> None:
        if encoder.dimension != store.config.dimension:
            raise ValueError(
                f"encoder dim {encoder.dimension} != store dim "
                f"{store.config.dimension}")
        self.encoder = encoder
        self.store = store
        self.batch_size = batch_size
        self._stats = {"texts_indexed": 0, "searches": 0}

    def process_texts(self, texts: list[str],
                      metadata: list[dict] | None = None) -> dict:
        """Batched encode -> add."""
        if metadata is None:
            metadata = [{} for _ in texts]
        if len(metadata) != len(texts):
            raise ValueError("metadata length != texts length")
        t0 = time.perf_counter()
        total = 0
        for start in range(0, len(texts), self.batch_size):
            batch = texts[start: start + self.batch_size]
            embeddings = self.encoder.encode(batch)
            meta = [{**m, "text": t} for m, t in
                    zip(metadata[start: start + self.batch_size], batch)]
            self.store.add_vectors(embeddings, meta)
            total += len(batch)
        dt = time.perf_counter() - t0
        self._stats["texts_indexed"] += total
        return {"texts_processed": total,
                "duration_s": round(dt, 3),
                "texts_per_second": round(total / max(dt, 1e-9), 1)}

    def search_similar_texts(self, query: str, k: int = 10,
                             filter_metadata: dict | None = None
                             ) -> list[dict]:
        """Encode -> query -> ranked dicts."""
        embedding = self.encoder.encode([query])[0]
        indices, scores, metadata = self.store.query(
            embedding, k=k, filter_metadata=filter_metadata)
        self._stats["searches"] += 1
        out = []
        for rank, (idx, raw, meta) in enumerate(
                zip(indices, scores, metadata), start=1):
            sim, dist = raw_score_to_similarity_distance(
                raw, self.store.metric)
            out.append({"rank": rank, "index": idx,
                        "similarity": float(sim), "distance": float(dist),
                        "text": meta.get("text", ""), "metadata": meta})
        return out

    def get_stats(self) -> dict:
        return {**self._stats, "encoder": self.encoder.get_stats(),
                "store": self.store.get_stats()}


@dataclass
class RetrievedContext:
    chunks: list[dict]
    total_chars: int
    query: str


class RAGPipeline:
    """Document indexing + context retrieval + prompt formatting."""

    def __init__(self, encoder: BaseEncoder, store: TorchVectorStore,
                 chunk_size: int = 512, chunk_overlap: int = 50,
                 batch_size: int = 32) -> None:
        self.pipeline = EmbeddingPipeline(encoder, store,
                                          batch_size=batch_size)
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

    def index_documents(self, documents: list[str],
                        doc_metadata: list[dict] | None = None) -> dict:
        """Chunk + embed + store."""
        if doc_metadata is None:
            doc_metadata = [{} for _ in documents]
        t0 = time.perf_counter()
        chunks, metas = [], []
        for doc_id, (doc, meta) in enumerate(zip(documents, doc_metadata)):
            for chunk_id, chunk in enumerate(
                    chunk_text(doc, self.chunk_size, self.chunk_overlap)):
                chunks.append(chunk)
                metas.append({**meta, "doc_id": doc_id,
                              "chunk_id": chunk_id})
        result = self.pipeline.process_texts(chunks, metas)
        dt = time.perf_counter() - t0
        return {"documents": len(documents), "chunks": len(chunks),
                "duration_s": round(dt, 3),
                "docs_per_second": round(len(documents) / max(dt, 1e-9), 1),
                "chunks_per_second": round(len(chunks) / max(dt, 1e-9), 1),
                **{k: v for k, v in result.items()
                   if k == "texts_per_second"}}

    def retrieve_context(self, query: str, k: int = 5,
                         min_similarity: float = 0.0,
                         max_context_chars: int = 4000) -> RetrievedContext:
        """Over-fetch 2k -> similarity floor -> length budget."""
        hits = self.pipeline.search_similar_texts(query, k=2 * k)
        chosen: list[dict] = []
        total = 0
        for hit in hits:
            if hit["similarity"] < min_similarity:
                continue
            text = hit["text"]
            if total + len(text) > max_context_chars:
                continue
            chosen.append(hit)
            total += len(text)
            if len(chosen) >= k:
                break
        return RetrievedContext(chunks=chosen, total_chars=total, query=query)

    def format_rag_prompt(self, query: str, context: RetrievedContext,
                          system_prompt: str | None = None) -> str:
        """Numbered context chunks, then the question."""
        parts = []
        if system_prompt:
            parts.append(system_prompt.strip())
        parts.append("Context:")
        for i, chunk in enumerate(context.chunks, start=1):
            parts.append(f"[{i}] {chunk['text']}")
        parts.append(f"\nQuestion: {query}\nAnswer:")
        return "\n\n".join(parts)

    def get_stats(self) -> dict:
        return self.pipeline.get_stats()


class PipelineFactory:
    """Model recommendation + assembly."""

    @staticmethod
    def recommend_model(use_case: str = "general",
                        memory_budget_mb: int | None = None) -> str:
        candidates = [
            (name, cfg) for name, cfg in EMBEDDING_MODEL_REGISTRY.items()
            if not name.startswith("hash-")
        ]
        if memory_budget_mb is not None:
            candidates = [(n, c) for n, c in candidates
                          if c.memory_estimate_mb <= memory_budget_mb]
        matching = [(n, c) for n, c in candidates if c.use_case == use_case]
        pool = matching or candidates
        if not pool:
            return "hash-384"
        # biggest model that fits = best quality
        return max(pool, key=lambda nc: nc[1].memory_estimate_mb)[0]

    @staticmethod
    def create_rag_pipeline(store_path, model_name: str | None = None,
                            use_case: str = "general",
                            memory_budget_mb: int | None = None,
                            metric: str = "cosine", device="cuda",
                            **rag_kwargs) -> RAGPipeline:
        """Encoder and store on ``device`` (default ``"cuda"``; raises
        without CUDA unless the caller passes ``"cpu"``)."""
        # imported here: the store imports index/native.py, whose loader
        # lives in this package
        from tpu_vector_db_torch.store.vector_store import TorchVectorStore
        name = model_name or PipelineFactory.recommend_model(
            use_case, memory_budget_mb)
        encoder = create_encoder(name, device=device)
        # resolve the TRUE dimension before sizing the store: hf:<dir>
        # encoders rewrite config.dimension to the checkpoint's hidden
        # size at load()
        if not encoder._loaded:
            encoder.load()
        store = TorchVectorStore(store_path, VectorStoreConfig(
            dimension=encoder.dimension, metric=metric,
            persist_mode="lazy"), device=device)
        return RAGPipeline(encoder, store, **rag_kwargs)
