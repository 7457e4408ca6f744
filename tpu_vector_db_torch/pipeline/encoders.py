"""Text encoders: model registry + hashing encoder + transformer encoders.

Counterpart of ``tpu_vector_db/pipeline/encoders.py``: a registry of named
embedding models with dimension/memory metadata, masked-mean-pool and
normalize, lazy load + warmup, ``encode`` with padding + attention masks,
and stats. Batches pad to the JAX package's fixed (batch, seq) buckets,
so both packages sum over the same shapes (and the shapes stay fixed for
CUDA graphs).

- ``HashingEncoder``: hashed tokens index rows of a seeded Gaussian
  table, the JAX package's own table (``prng.normal``), so both packages
  embed a text alike and a store indexed by one answers the other.
- ``TransformerEncoder``: the JAX ``FlaxTransformerEncoder`` (pre-LN
  blocks, Flax's ``MultiHeadDotProductAttention``) with the same
  parameter tree; weights from a Flax msgpack checkpoint or carried
  across from the JAX package (``bert.from_flax_params``). Its own random
  init is torch's, not Flax's.
- ``BertEncoder``: a HuggingFace checkpoint directory (BERT, RoBERTa,
  XLM-R, MPNet) with its tokenizer, quantized at load on request.

Every encoder takes ``device`` (default ``"cuda"``; it raises without
CUDA unless the caller passes ``"cpu"``) and returns float32 numpy rows.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import re
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_vector_db_torch.pipeline import bert as _bert
from tpu_vector_db_torch.pipeline import prng

logger = logging.getLogger(__name__)

# shape buckets: every encode pads (batch, seq) up to one of these
BATCH_BUCKETS = (1, 8, 32, 128)
SEQ_BUCKETS = (32, 128, 512)


@dataclass
class EncoderConfig:
    name: str = "hash-384"
    dimension: int = 384
    max_sequence_length: int = 512
    # transformer-encoder hyperparameters (ignored by the hashing encoder)
    vocab_size: int = 30522
    num_layers: int = 6
    num_heads: int = 6
    hidden_dim: int = 384
    mlp_dim: int = 1536
    dtype: str = "bfloat16"
    # local checkpoint: a flax msgpack file (or a directory holding one)
    # for TransformerEncoder, an HF directory for BertEncoder
    checkpoint_path: str | None = None
    # "none" | "int8" | "int4": weight quantization at load (BertEncoder)
    quantize: str = "none"
    memory_estimate_mb: int = 100
    use_case: str = "general"


# Named registry: the JAX package's, entry for entry
EMBEDDING_MODEL_REGISTRY: dict[str, EncoderConfig] = {
    "hash-256": EncoderConfig(name="hash-256", dimension=256,
                              memory_estimate_mb=1, use_case="ci"),
    "hash-384": EncoderConfig(name="hash-384", dimension=384,
                              memory_estimate_mb=1, use_case="ci"),
    "minilm-l6-384": EncoderConfig(
        name="minilm-l6-384", dimension=384, num_layers=6, num_heads=12,
        hidden_dim=384, mlp_dim=1536, memory_estimate_mb=90,
        use_case="general"),
    "bge-small-384": EncoderConfig(
        name="bge-small-384", dimension=384, num_layers=12, num_heads=12,
        hidden_dim=384, mlp_dim=1536, memory_estimate_mb=130,
        use_case="retrieval"),
    "bge-base-768": EncoderConfig(
        name="bge-base-768", dimension=768, num_layers=12, num_heads=12,
        hidden_dim=768, mlp_dim=3072, memory_estimate_mb=440,
        use_case="quality"),
    "gte-large-1024": EncoderConfig(
        name="gte-large-1024", dimension=1024, num_layers=24, num_heads=16,
        hidden_dim=1024, mlp_dim=4096, memory_estimate_mb=1340,
        use_case="quality"),
    "multilingual-512": EncoderConfig(
        name="multilingual-512", dimension=512, num_layers=12, num_heads=8,
        hidden_dim=512, mlp_dim=2048, memory_estimate_mb=470,
        use_case="multilingual"),
    # non-BERT architectures, served pretrained via hf:<dir> (model_type
    # mpnet / xlm-roberta); these entries give the shape and the random
    # init the right hyperparameters
    "mpnet-base-768": EncoderConfig(
        name="mpnet-base-768", dimension=768, num_layers=12, num_heads=12,
        hidden_dim=768, mlp_dim=3072, vocab_size=30527,
        memory_estimate_mb=420, use_case="quality"),
    "multilingual-e5-small-384": EncoderConfig(
        name="multilingual-e5-small-384", dimension=384, num_layers=12,
        num_heads=12, hidden_dim=384, mlp_dim=1536, vocab_size=250002,
        memory_estimate_mb=470, use_case="multilingual"),
    "multilingual-e5-base-768": EncoderConfig(
        name="multilingual-e5-base-768", dimension=768, num_layers=12,
        num_heads=12, hidden_dim=768, mlp_dim=3072, vocab_size=250002,
        memory_estimate_mb=1070, use_case="multilingual"),
}


# ------------------------------------------------------------------ pooling

def masked_mean_pool(hidden: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """(B, S, D) x (B, S) -> (B, D), float32."""
    m = mask.float()[:, :, None]
    summed = torch.sum(hidden.float() * m, dim=1)
    return summed / torch.clamp(torch.sum(m, dim=1), min=1e-9)


def l2_normalize_embeddings(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


def _bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


# ------------------------------------------------------------- tokenization

_TOKEN_RE = re.compile(r"[a-z0-9']+")


class HashTokenizer:
    """Deterministic hashing tokenizer (no vocab files needed)."""

    def __init__(self, vocab_size: int, max_len: int) -> None:
        self.vocab_size = vocab_size
        self.max_len = max_len

    def encode_batch(self, texts: list[str], seq_len: int):
        ids = np.zeros((len(texts), seq_len), np.int32)
        mask = np.zeros((len(texts), seq_len), np.int32)
        for i, text in enumerate(texts):
            tokens = _TOKEN_RE.findall(text.lower())[: seq_len]
            for j, tok in enumerate(tokens):
                digest = hashlib.blake2b(tok.encode(), digest_size=4).digest()
                ids[i, j] = int.from_bytes(digest, "little") % self.vocab_size
            mask[i, : len(tokens)] = 1
        return ids, mask


def _hash_token_ids(tokenizer: HashTokenizer, texts: list[str]):
    """Bucketed (ids, mask) of the hashing tokenizer; a fully empty row
    gets one live token so that its pool is not 0 / 0."""
    n = len(texts)
    seq = _bucket(max((len(_TOKEN_RE.findall(t.lower())) for t in texts),
                      default=1), SEQ_BUCKETS)
    b = _bucket(n, BATCH_BUCKETS)
    ids, mask = tokenizer.encode_batch(texts + [""] * (b - n), seq)
    mask[mask.sum(1) == 0, 0] = 1
    return ids, mask


# ---------------------------------------------------------- base interface

class BaseEncoder:
    """encode(texts) -> (N, dim) float32 normalized embeddings."""

    config: EncoderConfig

    #: device-batch ceiling; encoders whose _encode pads to fixed batch
    #: buckets set this so oversized inputs chunk instead of overflowing
    _max_batch: int | None = None

    def __init__(self, config: EncoderConfig, device="cuda") -> None:
        # imported here: the store imports index/native.py, whose loader
        # lives in this package
        from tpu_vector_db_torch.store.vector_store import resolve_device
        self.config = config
        self.device = resolve_device(device)
        self._stats = {"texts": 0, "batches": 0, "total_time_s": 0.0}
        self._loaded = False

    @property
    def dimension(self) -> int:
        return self.config.dimension

    def load(self) -> None:
        self._loaded = True

    def warmup(self) -> dict:
        t0 = time.perf_counter()
        self.encode(["warmup probe text"])
        return {"warmed": True,
                "duration_ms": (time.perf_counter() - t0) * 1e3}

    def encode(self, texts: list[str]) -> np.ndarray:
        if not self._loaded:
            self.load()
        t0 = time.perf_counter()
        mb = self._max_batch
        with torch.inference_mode():
            if mb is not None and len(texts) > mb:
                out = np.concatenate([self._encode(texts[i: i + mb])
                                      for i in range(0, len(texts), mb)])
            else:
                out = self._encode(texts)
        dt = time.perf_counter() - t0
        self._stats["texts"] += len(texts)
        self._stats["batches"] += 1
        self._stats["total_time_s"] += dt
        return out

    def _encode(self, texts: list[str]) -> np.ndarray:
        raise NotImplementedError

    def _ids_on_device(self, ids: np.ndarray, mask: np.ndarray):
        """Host (ids, mask) -> int64 ids and int32 mask on the device."""
        return (torch.from_numpy(ids).to(self.device).long(),
                torch.from_numpy(mask).to(self.device))

    def get_stats(self) -> dict:
        s = dict(self._stats)
        s["texts_per_second"] = (s["texts"] / s["total_time_s"]
                                 if s["total_time_s"] else 0.0)
        s["model"] = self.config.name
        s["dimension"] = self.dimension
        return s


# --------------------------------------------------------- hashing encoder

class HashingEncoder(BaseEncoder):
    """Deterministic random-projection embedding: hashed tokens index rows
    of the JAX package's seeded Gaussian table (``prng.normal``) divided
    by sqrt(dim); masked mean pool + L2 normalize. Zero external
    weights; lexical overlap -> similar embeddings."""

    _max_batch = BATCH_BUCKETS[-1]

    def __init__(self, config: EncoderConfig, seed: int = 0,
                 device="cuda") -> None:
        super().__init__(config, device)
        self._seed = seed
        self._table: torch.Tensor | None = None
        self._tokenizer = HashTokenizer(config.vocab_size,
                                        config.max_sequence_length)

    def load(self) -> None:
        table = prng.normal(self._seed, (self.config.vocab_size,
                                         self.config.dimension))
        # as the JAX encoder divides: by sqrt(dim) rounded to float32
        self._table = (table / np.float32(np.sqrt(self.config.dimension))
                       ).to(self.device)
        self._loaded = True

    def _encode(self, texts: list[str]) -> np.ndarray:
        ids, mask = self._ids_on_device(
            *_hash_token_ids(self._tokenizer, texts))
        hidden = F.embedding(ids, self._table)
        out = l2_normalize_embeddings(masked_mean_pool(hidden, mask))
        return out[: len(texts)].cpu().numpy()


# ------------------------------------------------- transformer (Flax tree)

class _Attention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (deterministic): q/k/v
    DenseGeneral to (heads, head_dim), query scaled by 1/sqrt(head_dim)
    in the compute dtype, logits and softmax in the compute dtype, masked
    with the dtype's most negative value, the output DenseGeneral over
    (heads, head_dim)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, dim // heads, dtype
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _bert.Linear(dim, dim, dtype))

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def heads(t):
            return t.view(b, s, self.heads, self.head_dim).transpose(1, 2)

        depth = torch.tensor(math.sqrt(self.head_dim), dtype=self.dtype,
                             device=x.device)
        q = heads(self.query(x)) / depth
        k, v = heads(self.key(x)), heads(self.value(x))
        logits = torch.matmul(q, k.transpose(2, 3))
        logits = logits.masked_fill(~keep, torch.finfo(self.dtype).min)
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        ctx = torch.matmul(w, v).transpose(1, 2).reshape(b, s, d)
        return self.out(ctx)


class _Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + MLP(LN(x)) (tanh GELU)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        d = cfg.hidden_dim
        self.LayerNorm_0 = _bert.LayerNorm(d, 1e-6)
        self.MultiHeadDotProductAttention_0 = _Attention(d, cfg.num_heads,
                                                         dtype)
        self.LayerNorm_1 = _bert.LayerNorm(d, 1e-6)
        self.Dense_0 = _bert.Linear(d, cfg.mlp_dim, dtype)
        self.Dense_1 = _bert.Linear(cfg.mlp_dim, d, dtype)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), keep)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class _TransformerModule(nn.Module):
    """The JAX encoder's module; attribute names are its Flax tree's."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.Embed_0 = _bert.Embedding(cfg.vocab_size, cfg.hidden_dim, dtype)
        self.Embed_1 = _bert.Embedding(cfg.max_sequence_length,
                                       cfg.hidden_dim, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"Block_{i}", _Block(cfg, dtype))
        self.LayerNorm_0 = _bert.LayerNorm(cfg.hidden_dim, 1e-6)
        if cfg.hidden_dim != cfg.dimension:
            self.Dense_0 = _bert.Linear(cfg.hidden_dim, cfg.dimension, dtype)

    def init_random(self, seed: int) -> None:
        """Weights from a torch.Generator (not Flax's init): Dense and
        Embed N(0, 1/fan_in), LayerNorm scale 1, biases 0."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight") and p.ndim == 2:
                    p.copy_(torch.randn(*p.shape, generator=g)
                            / math.sqrt(p.shape[1]))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.Embed_0(ids) + self.Embed_1(pos)
        keep = mask[:, None, None, :].bool()
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"Block_{i}")(x, keep)
        x = self.LayerNorm_0(x)
        if hasattr(self, "Dense_0"):
            x = self.Dense_0(x)
        return x


class TransformerEncoder(BaseEncoder):
    """Transformer encoder over the hashing tokenizer: token + position
    embeddings, N pre-LN self-attention blocks, masked mean pool,
    normalize; the JAX ``FlaxTransformerEncoder``'s parameter tree.
    Random-initialized (torch's init) unless ``config.checkpoint_path``
    names a flax msgpack state, or ``load_flax_params`` is given one."""

    _max_batch = BATCH_BUCKETS[-1]

    def __init__(self, config: EncoderConfig, seed: int = 0,
                 device="cuda") -> None:
        super().__init__(config, device)
        self._seed = seed
        self._model: _TransformerModule | None = None
        self._tokenizer = HashTokenizer(config.vocab_size,
                                        config.max_sequence_length)

    def load(self) -> None:
        cfg = self.config
        model = _TransformerModule(cfg, _bert.compute_dtype_of(cfg.dtype))
        model.init_random(self._seed)
        self._model = model.to(self.device).eval().requires_grad_(False)
        if cfg.checkpoint_path:
            self._load_checkpoint(cfg.checkpoint_path)
        self._loaded = True
        logger.info("encoder %s loaded (%d layers, dim %d)",
                    cfg.name, cfg.num_layers, cfg.dimension)

    def load_flax_params(self, variables: dict) -> None:
        """Take the JAX encoder's parameter tree (numpy or jax arrays)."""
        if self._model is None:
            self.load()
        self._model.load_state_dict(_bert.from_flax_params(variables))

    def _load_checkpoint(self, path: str) -> None:
        ckpt = Path(path)
        candidates = [ckpt] if ckpt.is_file() else \
            list(ckpt.glob("*.msgpack"))
        if not candidates:
            logger.warning("no checkpoint at %s; using random init", path)
            return
        self.load_flax_params(read_flax_msgpack(candidates[0].read_bytes()))
        logger.info("loaded checkpoint %s", candidates[0])

    def _encode(self, texts: list[str]) -> np.ndarray:
        ids, mask = self._ids_on_device(
            *_hash_token_ids(self._tokenizer, texts))
        hidden = self._model(ids, mask)
        out = l2_normalize_embeddings(masked_mean_pool(hidden, mask))
        return out[: len(texts)].cpu().numpy()


# --------------------------------------------- flax msgpack (to_bytes) reader

_MSGPACK_NDARRAY = 1      # flax's ext type of an ndarray


class _MsgpackReader:
    """The msgpack subset ``flax.serialization.to_bytes`` writes for a
    parameter tree: maps with string keys, and ndarray leaves as flax's
    ext type, a packed ``(shape, dtype name, buffer)`` (so arrays,
    unsigned integers and binaries too). Anything else raises."""

    def __init__(self, data: bytes) -> None:
        self.data, self.pos = memoryview(data), 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def read(self):
        t = self._take(1)[0]
        if t <= 0x7F:                            # positive fixint
            return t
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self._take(t & 0x1F)).decode("utf-8")
        if t in (0xC4, 0xC5, 0xC6):              # bin 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):              # ext 8/16/32
            n = self._uint(1 << (t - 0xC7))
            return self._ext(self._take(1)[0], n)
        if 0xCC <= t <= 0xCF:                    # uint 8/16/32/64
            return self._uint(1 << (t - 0xCC))
        if 0xD4 <= t <= 0xD8:                    # fixext 1/2/4/8/16
            return self._ext(self._take(1)[0], 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):              # str 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xD9)))
                         ).decode("utf-8")
        if t in (0xDC, 0xDD):                    # array 16/32
            return [self.read() for _ in range(self._uint(2 << (t - 0xDC)))]
        if t in (0xDE, 0xDF):                    # map 16/32
            return self._map(self._uint(2 << (t - 0xDE)))
        raise ValueError(f"msgpack type byte {t:#x} is not supported")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int) -> np.ndarray:
        payload = bytes(self._take(n))
        if code != _MSGPACK_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, dtype, buf = _MsgpackReader(payload).read()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def read_flax_msgpack(data: bytes) -> dict:
    """``flax.serialization.to_bytes(params)`` -> the tree, numpy leaves."""
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


# -------------------------------------------------- pretrained HF encoders

class BertEncoder(BaseEncoder):
    """Serves a pretrained transformer checkpoint from a local
    directory, dispatching on config.json ``model_type``:

    - ``bert`` (MiniLM, bge-*, gte-*, any HF BertModel): WordPiece over
      vocab.txt + the BERT forward (``bert.py``).
    - ``xlm-roberta`` / ``roberta`` (multilingual-e5-*): Unigram/
      SentencePiece over tokenizer.json (``unigram.py``) + the same
      encoder stack with RoBERTa position indexing.
    - ``mpnet`` (all-mpnet-base-v2): WordPiece with <s>/</s>/<pad>
      framing + MPNet with its shared relative-position bias
      (``mpnet.py``).

    Point checkpoint_path at a directory holding config.json + the
    tokenizer files + model.safetensors (or pytorch_model.bin). Mean or
    CLS pooling, L2 normalize; quantize="int8"/"int4" applies to all
    three families."""

    _max_batch = BATCH_BUCKETS[-1]

    def __init__(self, config: EncoderConfig, pooling: str = "mean",
                 device="cuda") -> None:
        super().__init__(config, device)
        if not config.checkpoint_path:
            raise ValueError("BertEncoder needs config.checkpoint_path "
                             "pointing at an HF checkpoint directory")
        self.pooling = pooling
        self._model: nn.Module | None = None
        self._tokenizer = None

    def _make_tokenizer(self, ckpt: Path, model_type: str):
        # the C++ fast paths, with their Python fallbacks inside
        from tpu_vector_db_torch.pipeline.fast_unigram import \
            FastUnigramTokenizer
        from tpu_vector_db_torch.pipeline.fast_wordpiece import \
            FastWordPieceTokenizer

        if model_type == "mpnet":
            return FastWordPieceTokenizer(
                ckpt / "vocab.txt", pad_token="<pad>", cls_token="<s>",
                sep_token="</s>", unk_token="[UNK]")
        tj = ckpt / "tokenizer.json"
        if model_type in ("roberta", "xlm-roberta"):
            if not tj.exists():
                raise FileNotFoundError(
                    f"{model_type} checkpoint needs tokenizer.json "
                    f"(Unigram/SentencePiece) in {ckpt}")
            return FastUnigramTokenizer(tj)
        # BERT family: prefer vocab.txt; fall back to a Unigram
        # tokenizer.json if that is all the checkpoint ships
        if (ckpt / "vocab.txt").exists():
            return FastWordPieceTokenizer(ckpt / "vocab.txt")
        return FastUnigramTokenizer(tj)

    def load(self) -> None:
        from tpu_vector_db_torch.pipeline import mpnet

        ckpt = Path(self.config.checkpoint_path)
        raw_cfg = json.loads((ckpt / "config.json").read_text())
        model_type = raw_cfg.get("model_type", "bert")
        dtype = _bert.compute_dtype_of(self.config.dtype)
        quant = self.config.quantize
        if quant not in ("none", "int8", "int4"):
            raise ValueError(
                f"quantize must be 'none', 'int8' or 'int4', got {quant!r}")
        quantized = False if quant == "none" else quant

        if model_type == "mpnet":
            arch = mpnet.MPNetConfig.from_hf_dir(ckpt)
            model = mpnet.make_mpnet_module(arch, dtype, quantized)
            params = mpnet.load_hf_params(ckpt, arch)
            quantizer = mpnet.quantize_params
        else:  # bert / roberta / xlm-roberta share the module
            arch = _bert.BertConfig.from_hf_dir(ckpt)
            model = _bert.make_bert_module(arch, dtype, quantized)
            params = _bert.load_hf_params(ckpt, arch)
            quantizer = _bert.quantize_params
        self._arch_cfg = arch
        if quantized:
            f32_bytes = _bert.param_bytes(params)
            params = quantizer(params, bits=4 if quant == "int4" else 8)
            logger.info("%s-quantized %s: %.1f -> %.1f MB params", quant,
                        self.config.name, f32_bytes / 2**20,
                        _bert.param_bytes(params) / 2**20)
        self._model = _bert.load_module(model, params, self.device)
        self._tokenizer = self._make_tokenizer(ckpt, model_type)
        self._loaded = True
        # clamp the tokenizer max_length to the checkpoint's position
        # table, so that no position id falls past it. RoBERTa-style
        # positions start at pad_id+1, costing 2 slots.
        pos_budget = arch.max_position_embeddings
        if getattr(arch, "model_type", "bert") in (
                "roberta", "xlm-roberta", "mpnet"):
            pos_budget -= 2
        if self.config.max_sequence_length > pos_budget:
            logger.warning(
                "max_sequence_length %d exceeds the checkpoint's position "
                "table (%d usable); clamping",
                self.config.max_sequence_length, pos_budget)
            self.config.max_sequence_length = pos_budget
        # the served dimension is the checkpoint's hidden size
        if self.config.dimension != arch.hidden_size:
            logger.warning(
                "config dimension %d != checkpoint hidden %d; serving %d",
                self.config.dimension, arch.hidden_size, arch.hidden_size)
            self.config.dimension = arch.hidden_size
        logger.info("%s encoder %s loaded from %s (%d layers, %s pooling)",
                    model_type, self.config.name, ckpt,
                    arch.num_hidden_layers, self.pooling)

    def _forward(self, ids: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
        """Device (ids, mask) -> pooled, normalized float32 rows."""
        return _bert.pool_hidden(self._model(ids, mask), mask, self.pooling)

    def _encode(self, texts: list[str]) -> np.ndarray:
        n = len(texts)
        b = _bucket(n, BATCH_BUCKETS)
        padded = texts + [""] * (b - n)
        # one tokenizer pass decides the sequence bucket ([CLS]+[SEP] =
        # +2). max_length is clamped to the largest bucket so that the
        # TOKENIZER truncates, keeping the trailing [SEP]
        max_len = min(self.config.max_sequence_length, SEQ_BUCKETS[-1])
        rows = [self._tokenizer.encode(t, max_length=max_len)
                for t in padded]
        seq = _bucket(max(len(r) for r in rows), SEQ_BUCKETS)
        ids = np.full((b, seq), self._tokenizer.pad_id, np.int32)
        mask = np.zeros((b, seq), np.int32)
        for i, row in enumerate(rows):
            row = row[:seq]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        out = self._forward(*self._ids_on_device(ids, mask))
        return out[:n].cpu().numpy()


def create_encoder(model_name: str = "hash-384", device="cuda",
                   **overrides) -> BaseEncoder:
    """Factory over the registry; hash-* -> HashingEncoder, hf:<dir> or a
    checkpoint_path holding an HF config.json -> BertEncoder (pretrained
    weights), else the transformer encoder."""
    pooling = overrides.pop("pooling", "mean")
    if model_name.startswith("hf:"):
        path = model_name[3:]
        cfg = EncoderConfig(name=Path(path).name or "hf-bert",
                            checkpoint_path=path, **overrides)
        return BertEncoder(cfg, pooling=pooling, device=device)
    if model_name not in EMBEDDING_MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {model_name!r}; available: "
            f"{sorted(EMBEDDING_MODEL_REGISTRY)} or 'hf:<checkpoint dir>'")
    cfg = EMBEDDING_MODEL_REGISTRY[model_name]
    if overrides:
        cfg = replace(cfg, **overrides)
    if model_name.startswith("hash-"):
        return HashingEncoder(cfg, device=device)
    ckpt = cfg.checkpoint_path
    if ckpt and (Path(ckpt) / "config.json").exists():
        return BertEncoder(cfg, pooling=pooling, device=device)
    return TransformerEncoder(cfg, device=device)
