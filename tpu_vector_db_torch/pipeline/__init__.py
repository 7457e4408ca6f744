"""Embedding + RAG pipeline.

Counterpart of ``tpu_vector_db/pipeline``: tokenizers (WordPiece,
Unigram, their native C++ fast paths over ``native/*.cpp``), the BERT /
RoBERTa / XLM-R and MPNet encoders (``bert.py``, ``mpnet.py``), the
encoder registry and factory (``encoders.py``: hashing, transformer and
pretrained HF encoders), and the text / RAG pipeline over
``TorchVectorStore`` (``pipeline.py``). Encoders run on the card unless
the caller passes ``device="cpu"``; the default encoder is the
weights-free hashing projection, the JAX package's own table.
"""

from tpu_vector_db_torch.pipeline.encoders import (  # noqa: F401
    EMBEDDING_MODEL_REGISTRY,
    BertEncoder,
    EncoderConfig,
    HashingEncoder,
    TransformerEncoder,
    create_encoder,
)
from tpu_vector_db_torch.pipeline.pipeline import (  # noqa: F401
    EmbeddingPipeline,
    PipelineFactory,
    RAGPipeline,
    chunk_text,
)
