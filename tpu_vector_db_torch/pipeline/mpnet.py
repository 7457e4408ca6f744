"""MPNet encoder in PyTorch + HF checkpoint weight mapping.

Counterpart of ``tpu_vector_db/pipeline/mpnet.py`` (all-mpnet-base-v2):
an MPNet-architecture sentence encoder, NOT a BERT: it has no token-type
embeddings, indexes absolute positions RoBERTa-style from padding_idx=1,
and adds a T5-style relative position bias (32 log-bucketed buckets,
max_distance=128, one shared (buckets, heads) table for the whole stack)
to every attention score. The encoder block, the layers and the
quantization are ``bert.py``'s; the rounding points are the JAX
module's (``bert.py``'s docstring). The (32, heads) bias table stays
float32 when the rest is quantized (``quantize_params``).

The relative-position bucket matrix depends only on the sequence length;
it is computed on the CPU with float32 arithmetic written as HF's
``MPNetEncoder.relative_position_bucket`` (which the JAX function equals,
``tests/test_mpnet.py``) and copied to the device, so the truncation of
``log`` at exact bucket edges is the CPU's on every device.
"""

from __future__ import annotations

import json
import logging
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from tpu_vector_db_torch.pipeline import bert as _bert
from tpu_vector_db_torch.pipeline.bert import (  # noqa: F401
    from_flax_params, load_module)

logger = logging.getLogger(__name__)


@dataclass
class MPNetConfig:
    vocab_size: int = 30527
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    relative_attention_num_buckets: int = 32
    pad_token_id: int = 1
    model_type: str = "mpnet"

    @classmethod
    def from_hf_dir(cls, path: str | Path) -> "MPNetConfig":
        raw = json.loads((Path(path) / "config.json").read_text())
        fields = {f: raw[f] for f in cls.__dataclass_fields__ if f in raw}
        return cls(**fields)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5-style log bucketing, exactly
    MPNetEncoder.relative_position_bucket (modeling_mpnet.py): sign takes
    half the buckets, |n| < buckets/4 exact, larger distances log-spaced
    up to max_distance. Run it on CPU tensors (see the module
    docstring)."""
    n = -relative_position.long()
    num_buckets //= 2
    ret = (n < 0).long() * num_buckets
    n = torch.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # .long() truncates toward zero; log(0) is masked out by is_small
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).long()
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class MPNetModel(nn.Module):
    """MPNetModel: (ids, mask) -> the last hidden state (B, S, H) in the
    compute dtype. Parameter names are the JAX module's tree paths."""

    def __init__(self, cfg: MPNetConfig, compute_dtype=torch.bfloat16,
                 quantized=False) -> None:
        super().__init__()
        mode = _bert.quant_mode(quantized)
        self.cfg = cfg
        self.dtype = _bert.compute_dtype_of(compute_dtype)
        _, embed = _bert.make_layer_factories(self.dtype, mode)
        self.word_embeddings = embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = embed(cfg.max_position_embeddings,
                                         cfg.hidden_size)
        self.emb_layernorm = _bert.LayerNorm(cfg.hidden_size,
                                             cfg.layer_norm_eps)
        # always a float32 table, also when the rest is quantized
        self.rel_bias = _bert.Embedding(cfg.relative_attention_num_buckets,
                                        cfg.num_attention_heads,
                                        torch.float32)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", _bert.EncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, cfg.layer_norm_eps, cfg.hidden_act,
                self.dtype, mode, ("q", "k", "v", "o")))
        self._buckets: dict[tuple[int, str], torch.Tensor] = {}

    def _bucket_matrix(self, s: int, device) -> torch.Tensor:
        """(S, S) relative-position buckets, computed once a length and
        device."""
        key = (s, str(device))
        if key not in self._buckets:
            pos = torch.arange(s)
            self._buckets[key] = relative_position_bucket(
                pos[None, :] - pos[:, None],
                self.cfg.relative_attention_num_buckets).to(device)
        return self._buckets[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        word = self.word_embeddings(ids)
        pos_ids = _bert.roberta_position_ids(ids, mask, self.cfg.pad_token_id)
        pos = self.position_embeddings(pos_ids)
        x = self.emb_layernorm(word + pos).to(self.dtype)
        # shared relative position bias (MPNetEncoder.compute_position_bias)
        rel = self.rel_bias(self._bucket_matrix(ids.shape[1], ids.device))
        pos_bias = rel.permute(2, 0, 1)[None]                # (1, H, S, S)
        attn_mask = (1.0 - mask[:, None, None, :].float()) * -1e9
        bias = pos_bias + attn_mask
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        return x


def make_mpnet_module(cfg: MPNetConfig, compute_dtype=torch.bfloat16,
                      quantized=False) -> MPNetModel:
    """The module, parameters zero until ``load_state_dict``."""
    return MPNetModel(cfg, compute_dtype=compute_dtype, quantized=quantized)


def load_hf_params(model_dir: str | Path, cfg: MPNetConfig) -> dict:
    """HF MPNetModel state dict -> the JAX module's param tree, float32
    numpy. Accepts bare MPNetModel keys and task-model keys with an
    ``mpnet.`` prefix; the pooler head is ignored."""
    model_dir = Path(model_dir)
    raw = _bert._read_hf_state_dict(model_dir)
    state = {}
    for k, v in raw.items():
        state[k[6:] if k.startswith("mpnet.") else k] = v

    def f32(name):
        return np.asarray(state[name], np.float32)

    def emb(key):
        return {"embedding": f32(key)}

    def ln(prefix):
        return {"scale": f32(f"{prefix}.weight"),
                "bias": f32(f"{prefix}.bias")}

    def dense(prefix):
        return {"kernel": f32(f"{prefix}.weight").T,
                "bias": f32(f"{prefix}.bias")}

    params = {
        "word_embeddings": emb("embeddings.word_embeddings.weight"),
        "position_embeddings": emb("embeddings.position_embeddings.weight"),
        "emb_layernorm": ln("embeddings.LayerNorm"),
        "rel_bias": emb("encoder.relative_attention_bias.weight"),
    }
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.attn.q.weight" in state:
        n_layers += 1
    if n_layers != cfg.num_hidden_layers:
        raise ValueError(f"checkpoint has {n_layers} layers, config says "
                         f"{cfg.num_hidden_layers}")
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "q": dense(f"{p}.attention.attn.q"),
            "k": dense(f"{p}.attention.attn.k"),
            "v": dense(f"{p}.attention.attn.v"),
            "o": dense(f"{p}.attention.attn.o"),
            "attn_layernorm": ln(f"{p}.attention.LayerNorm"),
            "intermediate": dense(f"{p}.intermediate.dense"),
            "output": dense(f"{p}.output.dense"),
            "out_layernorm": ln(f"{p}.output.LayerNorm"),
        }
    logger.info("mapped HF MPNet checkpoint %s: %d layers, hidden %d",
                model_dir, n_layers, cfg.hidden_size)
    return {"params": params}


def quantize_params(variables: dict, bits: int = 8) -> dict:
    """int8/int4 weight quantization for an MPNet tree: bert.py's
    quantizer, with the (buckets, heads) rel-pos bias table kept float32
    (tiny and precision-sensitive: it feeds raw attention logits)."""
    return _bert.quantize_params(variables, bits=bits,
                                 keep_f32=("rel_bias",))
