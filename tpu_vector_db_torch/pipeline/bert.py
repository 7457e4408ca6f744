"""BERT / RoBERTa / XLM-R encoder in PyTorch + HF checkpoint weight mapping.

Counterpart of ``tpu_vector_db/pipeline/bert.py``: a BERT-architecture
``nn.Module`` whose parameters map 1:1 onto HuggingFace ``BertModel``
checkpoints (``pytorch_model*.bin`` or ``model.safetensors``), the loader
that performs the mapping, the int8/int4 weight quantizer and pooling.
MiniLM-L6, bge-small/base and every other BERT-family sentence encoder
load through this path; RoBERTa and XLM-R checkpoints share the encoder
stack and differ only in their position ids.

Parameters travel as the JAX package's tree (``{"params": {name:
{leaf: array}}}``, numpy): ``load_hf_params`` reads a checkpoint into
that tree, ``quantize_params`` is a numpy copy of the JAX quantizer (so
both packages hold the same int8/int4 bytes), and ``from_flax_params``
turns any such tree, the JAX package's own included, into this module's
``state_dict`` (Flax kernels are (in, out); torch weights (out, in)).

Numerics follow the JAX module, not HF's, rounding point for rounding
point (``tests/test_torch_bert.py`` holds them against each other):

- a Dense layer returns its product in the compute dtype and adds its
  bias in that dtype (no fused bias epilogue);
- the residual sum ``x + a`` is taken in the compute dtype; the
  LayerNorm then runs in float32 and its output is cast back;
- attention logits are float32 from compute-dtype operands (q and k are
  widened, so the products are exact and the sums float32: TF32 is off),
  probabilities are cast to the compute dtype for the second product,
  whose output rounds to the compute dtype once;
- the padding mask is a float32 bias of -1e9, so a fully padded row
  stays finite;
- ids are clamped into their table before a gather: a CUDA gather past
  the end would fault the device (the JAX module's int8 tables clamp
  there, its float tables, read by ``jnp.take``, give NaN; the encoders
  keep every id inside its table, so neither is reached).

The LayerNorm is ``F.layer_norm`` (two-pass variance) where Flax takes
E[x²] − E[x]²: in float32 the two differ by a few ulps of the
normalised value (the f32 tests hold pooled embeddings within 1e-5).
Nothing here is a kernel of the repository: the forward is torch ops and
``torch.matmul``, as the JAX module's is XLA.
"""

from __future__ import annotations

import json
import logging
import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    # "bert" | "roberta" | "xlm-roberta": RoBERTa-family checkpoints share
    # the BERT encoder but index position embeddings from pad_token_id+1
    model_type: str = "bert"
    pad_token_id: int = 0

    @classmethod
    def from_hf_dir(cls, path: str | Path) -> "BertConfig":
        """Read the subset of HF config.json this module needs."""
        raw = json.loads((Path(path) / "config.json").read_text())
        fields = {f: raw[f] for f in cls.__dataclass_fields__ if f in raw}
        return cls(**fields)


# int4 quantization group: input rows sharing one scale per output channel
Q4_GROUP = 64

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return _DTYPES[dtype]


def quant_mode(quantized) -> str | None:
    """Normalize the quantized flag: False/None | True/'int8' | 'int4'."""
    mode = "int8" if quantized is True else (quantized or None)
    if mode not in (None, "int8", "int4"):
        raise ValueError(f"quantized must be False/'int8'/'int4', "
                         f"got {quantized!r}")
    return mode


# ------------------------------------------------------------------ layers

class Linear(nn.Module):
    """``nn.Dense(dtype=dtype)``: weight and bias held in the compute
    dtype (Flax casts its float32 params at every call; a checkpoint's
    float32 values are cast once at load, to the same values)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return torch.matmul(x.to(w.dtype), w.t()) + self.bias


class Int8Linear(nn.Module):
    """Per-output-channel symmetric int8 weights (``weight_q`` (out, in)
    and a float32 ``scale`` (out,)), widened and scaled to the compute
    dtype at every call (``bert.py:93-110`` of the JAX package, where XLA
    fuses this into the matmul's operand read; here it is materialised)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight_q.float() * self.scale[:, None]).to(self.dtype)
        return torch.matmul(x.to(self.dtype), w.t()) + self.bias.to(
            self.dtype)


class Int4Linear(nn.Module):
    """int4 weights packed two per byte along the INPUT dim (even inputs
    in the low nibble, stored +8), ``weight_q4`` (out, in / 2) uint8, and
    ``Q4_GROUP``-wise float32 scales ``scale`` (out, in / group)
    (``bert.py:112-136`` of the JAX package)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.group = min(Q4_GROUP, in_features)
        self.register_buffer("weight_q4", torch.zeros(
            out_features, in_features // 2, dtype=torch.uint8))
        self.register_buffer("scale", torch.ones(
            out_features, in_features // self.group))
        self.register_buffer("bias", torch.zeros(out_features))

    def dequantized(self) -> torch.Tensor:
        """The (out, in) float32 weight the packed nibbles stand for."""
        u = self.weight_q4.to(torch.int32)
        lo = (u & 15) - 8
        hi = ((u >> 4) & 15) - 8
        out_f = u.shape[0]
        k = torch.stack([lo, hi], dim=2).reshape(out_f, -1).float()
        k = k.reshape(out_f, -1, self.group) * self.scale[:, :, None]
        return k.reshape(out_f, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.dequantized().to(self.dtype)
        return torch.matmul(x.to(self.dtype), w.t()) + self.bias.to(
            self.dtype)


class Embedding(nn.Module):
    """``nn.Embed(dtype=dtype)``: the table in the compute dtype; ids
    clamped into the table (see the module docstring)."""

    def __init__(self, num: int, features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, features, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long().clamp(0, self.weight.shape[0] - 1),
                           self.weight)


class Int8Embedding(nn.Module):
    """Per-hidden-channel int8 table (``weight_q`` (num, features) and a
    float32 ``scale`` (features,)), ``bert.py:138-149`` of the JAX
    package; ids clamped into the table, as there."""

    def __init__(self, num: int, features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(num, features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight_q[ids.long().clamp(0, self.weight_q.shape[0] - 1)]
        return (rows.float() * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)``: float32 in, float32 out."""

    def __init__(self, features: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps)


def make_layer_factories(dtype: torch.dtype, mode: str | None):
    """(dense, embed) constructors for one transformer family, as the JAX
    package's: plain layers in ``dtype``; with mode "int8" int8 Dense
    weights, with "int4" packed int4 ones; embedding tables int8 in both
    quantized modes. Shared by the BERT module below and mpnet.py."""

    def dense(in_f: int, out_f: int) -> nn.Module:
        if mode == "int4":
            return Int4Linear(in_f, out_f, dtype)
        if mode == "int8":
            return Int8Linear(in_f, out_f, dtype)
        return Linear(in_f, out_f, dtype)

    def embed(num: int, features: int) -> nn.Module:
        return (Int8Embedding(num, features, dtype) if mode
                else Embedding(num, features, dtype))

    return dense, embed


def roberta_position_ids(ids: torch.Tensor, mask: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """RoBERTa/XLM-R position indexing: live token t gets position
    pad_id + (1-based index among live tokens); pads get pad_id
    (transformers' create_position_ids_from_input_ids)."""
    m = mask.long()
    return torch.cumsum(m, dim=1) * m + pad_id


class EncoderLayer(nn.Module):
    """One post-LN encoder block: self-attention, residual + LayerNorm,
    GELU MLP, residual + LayerNorm. ``names`` are the four attention
    projections' names in the parameter tree (BERT: query/key/value/
    attn_out; MPNet: q/k/v/o)."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 eps: float, act: str, dtype: torch.dtype, mode: str | None,
                 names: tuple[str, str, str, str]) -> None:
        super().__init__()
        dense, _ = make_layer_factories(dtype, mode)
        self.heads = heads
        self.head_dim = hidden // heads
        self.dtype = dtype
        self.approximate = "tanh" if act == "gelu_new" else "none"
        self.names = names
        for name in names:
            self.add_module(name, dense(hidden, hidden))
        self.attn_layernorm = LayerNorm(hidden, eps)
        self.intermediate = dense(hidden, intermediate)
        self.output = dense(intermediate, hidden)
        self.out_layernorm = LayerNorm(hidden, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        q_m, k_m, v_m, o_m = (getattr(self, n) for n in self.names)
        q = q_m(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        k = k_m(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        v = v_m(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        # f32 logits from widened operands: exact products, f32 sums
        scores = torch.matmul(q.float(), k.float().transpose(2, 3))
        scores = scores / math.sqrt(self.head_dim) + bias
        probs = torch.softmax(scores, dim=-1)
        # one rounding to the compute dtype, as ctx.astype(dtype)
        ctx = torch.matmul(probs.to(self.dtype), v)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        x = self.attn_layernorm(x + o_m(ctx)).to(self.dtype)
        hdn = F.gelu(self.intermediate(x), approximate=self.approximate)
        hdn = self.output(hdn)
        return self.out_layernorm(x + hdn).to(self.dtype)


class BertModel(nn.Module):
    """BertModel / RobertaModel / XLMRobertaModel: (ids, mask) -> the
    last hidden state (B, S, H) in the compute dtype. Parameter names are
    the JAX module's tree paths (``layer_0.query.weight`` is the tree's
    ``layer_0/query/kernel``, transposed)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.bfloat16,
                 quantized=False) -> None:
        super().__init__()
        mode = quant_mode(quantized)
        self.cfg = cfg
        self.dtype = compute_dtype_of(compute_dtype)
        self.roberta = cfg.model_type in ("roberta", "xlm-roberta")
        _, embed = make_layer_factories(self.dtype, mode)
        self.word_embeddings = embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = embed(cfg.max_position_embeddings,
                                         cfg.hidden_size)
        self.token_type_embeddings = embed(cfg.type_vocab_size,
                                           cfg.hidden_size)
        self.emb_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, cfg.layer_norm_eps, cfg.hidden_act,
                self.dtype, mode, ("query", "key", "value", "attn_out")))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        word = self.word_embeddings(ids)
        if self.roberta:
            pos_ids = roberta_position_ids(ids, mask, self.cfg.pad_token_id)
        else:
            pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        pos = self.position_embeddings(pos_ids)
        typ = self.token_type_embeddings(torch.zeros_like(ids))
        x = self.emb_layernorm(word + pos + typ).to(self.dtype)
        bias = (1.0 - mask[:, None, None, :].float()) * -1e9
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        return x


def make_bert_module(cfg: BertConfig, compute_dtype=torch.bfloat16,
                     quantized=False) -> BertModel:
    """The module, parameters zero until ``load_state_dict``."""
    return BertModel(cfg, compute_dtype=compute_dtype, quantized=quantized)


# ------------------------------------------------- Flax tree <-> state_dict

def _module_state(leaves: dict) -> dict[str, np.ndarray]:
    """One Flax module's leaves -> this package's tensor names."""
    out = {}
    if "kernel" in leaves:
        k, b = np.asarray(leaves["kernel"]), np.asarray(leaves["bias"])
        if k.ndim == 3 and b.ndim == 2:    # DenseGeneral (in, heads, dim)
            k, b = k.reshape(k.shape[0], -1), b.reshape(-1)
        elif k.ndim == 3:                  # DenseGeneral (heads, dim, out)
            k = k.reshape(-1, k.shape[-1])
        out["weight"], out["bias"] = k.T, b
    elif "kernel_q" in leaves:
        out["weight_q"] = np.asarray(leaves["kernel_q"]).T
        out["scale"] = leaves["scale"]
        out["bias"] = leaves["bias"]
    elif "kernel_q4" in leaves:
        out["weight_q4"] = np.asarray(leaves["kernel_q4"]).T
        out["scale"] = np.asarray(leaves["scale"]).T
        out["bias"] = leaves["bias"]
    elif "embedding" in leaves:
        out["weight"] = leaves["embedding"]
    elif "embedding_q" in leaves:
        out["weight_q"] = leaves["embedding_q"]
        out["scale"] = leaves["scale"]
    else:                                  # LayerNorm
        out["weight"], out["bias"] = leaves["scale"], leaves["bias"]
    return out


def from_flax_params(variables: dict) -> dict[str, torch.Tensor]:
    """A Flax param tree (``{"params": ...}`` or the bare tree; jax or
    numpy arrays; float32, int8 or int4 layout) -> this package's
    ``state_dict`` (CPU tensors; ``load_state_dict`` casts them to each
    parameter's dtype)."""
    tree = variables.get("params", variables)
    state: dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        if all(not isinstance(v, dict) for v in node.values()):
            for name, arr in _module_state(node).items():
                # a writable copy: checkpoint buffers are read-only
                state[prefix + name] = torch.from_numpy(np.array(arr))
            return
        for name, sub in node.items():
            walk(sub, f"{prefix}{name}.")

    walk(tree, "")
    return state


# ------------------------------------------------------------ HF weight map

# the safetensors dtypes the JAX loader reads (safetensors.numpy's table)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "U64": np.uint64, "I32": np.int32,
              "U32": np.uint32, "I16": np.int16, "U16": np.uint16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "C64": np.complex64}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: array}: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}}),
    then the raw little-endian buffers."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                f"readable: {sorted(_ST_DTYPES)}")
        start, stop = info["data_offsets"]
        arr = np.frombuffer(data[start:stop], dtype=np.dtype(dtype)
                            .newbyteorder("<"))
        out[name] = arr.reshape(info["shape"]).astype(dtype, copy=False)
    return out


def _read_hf_state_dict(model_dir: Path) -> dict[str, np.ndarray]:
    """Load the raw tensor dict from an HF checkpoint directory."""
    st = model_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model*.bin in {model_dir}")
    state: dict[str, np.ndarray] = {}
    for b in bins:
        sd = torch.load(b, map_location="cpu", weights_only=True)
        state.update({k: v.float().numpy() for k, v in sd.items()})
    return state


def load_hf_params(model_dir: str | Path, cfg: BertConfig) -> dict:
    """HF BertModel state dict -> the JAX module's param tree, float32
    numpy (``from_flax_params`` turns it into a ``state_dict``).

    Accepts bare BertModel/RobertaModel/XLMRobertaModel keys
    (``embeddings.word_embeddings.weight``) and task-model keys with a
    ``bert.``/``roberta.`` prefix. torch Linear weights are (out, in) and
    transpose to Flax (in, out) kernels; LayerNorm weight/bias become
    scale/bias."""
    model_dir = Path(model_dir)
    raw = _read_hf_state_dict(model_dir)
    state = {}
    for k, v in raw.items():
        for prefix in ("bert.", "roberta."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        state[k] = v

    def f32(name):
        return np.asarray(state[name], np.float32)

    def emb(name):
        return {"embedding": f32(f"embeddings.{name}.weight")}

    def ln(prefix):
        return {"scale": f32(f"{prefix}.weight"),
                "bias": f32(f"{prefix}.bias")}

    def dense(prefix):
        return {"kernel": f32(f"{prefix}.weight").T,
                "bias": f32(f"{prefix}.bias")}

    params = {
        "word_embeddings": emb("word_embeddings"),
        "position_embeddings": emb("position_embeddings"),
        "token_type_embeddings": emb("token_type_embeddings"),
        "emb_layernorm": ln("embeddings.LayerNorm"),
    }
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in state:
        n_layers += 1
    if n_layers != cfg.num_hidden_layers:
        raise ValueError(f"checkpoint has {n_layers} layers, config says "
                         f"{cfg.num_hidden_layers}")
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "query": dense(f"{p}.attention.self.query"),
            "key": dense(f"{p}.attention.self.key"),
            "value": dense(f"{p}.attention.self.value"),
            "attn_out": dense(f"{p}.attention.output.dense"),
            "attn_layernorm": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": dense(f"{p}.intermediate.dense"),
            "output": dense(f"{p}.output.dense"),
            "out_layernorm": ln(f"{p}.output.LayerNorm"),
        }
    logger.info("mapped HF checkpoint %s: %d layers, hidden %d",
                model_dir, n_layers, cfg.hidden_size)
    return {"params": params}


# --------------------------------------------------- int8/int4 quantization

def quantize_params(variables: dict, bits: int = 8,
                    keep_f32: tuple[str, ...] = ()) -> dict:
    """float32 param tree -> quantized tree for
    ``make_bert_module(quantized="int8"/"int4")``, a numpy copy of the
    JAX package's quantizer (the same bytes).

    bits=8: symmetric per-output-channel int8 scales for Dense kernels.
    bits=4: Dense kernels quantized to int4 with GROUP-wise scales
    (Q4_GROUP input rows per scale) and packed two-nibbles-per-byte.
    Embedding tables are per-hidden-channel int8 in both modes; LayerNorms
    and biases stay float32; modules named in ``keep_f32`` stay float32
    whole."""

    def q_matrix(m):
        m = np.asarray(m, np.float32)
        scale = np.maximum(np.max(np.abs(m), axis=0) / 127.0, 1e-12)
        q = np.clip(np.round(m / scale[None, :]), -127, 127).astype(np.int8)
        return q, scale.astype(np.float32)

    def q4_matrix(m):
        m = np.asarray(m, np.float32)
        in_f, out_f = m.shape
        g = min(Q4_GROUP, in_f)
        if in_f % g or in_f % 2:
            raise ValueError(
                f"int4 needs in_features divisible by {g}, got {in_f}")
        mg = m.reshape(in_f // g, g, out_f)
        scale = np.maximum(np.abs(mg).max(axis=1) / 7.0, 1e-12)  # (G, out)
        q = np.clip(np.round(mg / scale[:, None, :]), -8, 7)
        q = q.reshape(in_f, out_f).astype(np.int8)
        u = (q + 8).astype(np.uint8)
        packed = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
        return packed, scale.astype(np.float32)

    def f32(block):
        return {k: np.asarray(v, np.float32) for k, v in block.items()}

    def q_dense(d):
        if bits == 4:
            q, s = q4_matrix(d["kernel"])
            return {"kernel_q4": q, "scale": s,
                    "bias": np.asarray(d["bias"], np.float32)}
        q, s = q_matrix(d["kernel"])
        return {"kernel_q": q, "scale": s,
                "bias": np.asarray(d["bias"], np.float32)}

    def q_embed(d):
        q, s = q_matrix(d["embedding"])
        return {"embedding_q": q, "scale": s}

    out = {}
    for name, sub in variables["params"].items():
        if name in keep_f32:
            out[name] = f32(sub)
        elif "kernel" in sub:
            out[name] = q_dense(sub)
        elif "embedding" in sub:
            out[name] = q_embed(sub)
        elif name.startswith("layer_"):
            out[name] = {inner: (q_dense(block) if "kernel" in block
                                 else f32(block))
                         for inner, block in sub.items()}
        else:  # layernorms
            out[name] = f32(sub)
    return {"params": out}


def param_bytes(variables) -> int:
    """Total parameter bytes of a param tree or of a module (its
    parameters and buffers)."""
    if isinstance(variables, nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in variables.state_dict().values())
    total = 0
    for v in variables.values():
        total += param_bytes(v) if isinstance(v, dict) else \
            int(np.prod(np.shape(v))) * np.asarray(v).dtype.itemsize
    return total


def load_module(model: nn.Module, variables: dict, device) -> nn.Module:
    """``model`` holding ``variables`` (a Flax-layout tree), moved to
    ``device``, in inference mode."""
    model.load_state_dict(from_flax_params(variables))
    return model.to(device).eval().requires_grad_(False)


# ------------------------------------------------------------------ pooling

def pool_hidden(hidden: torch.Tensor, mask: torch.Tensor,
                pooling: str) -> torch.Tensor:
    """'mean' (MiniLM / sentence-transformers) or 'cls' (bge-*) pooling of
    the last hidden state, then L2 normalization; float32."""
    if pooling == "cls":
        pooled = hidden[:, 0, :].float()
    else:
        m = mask.float()[:, :, None]
        pooled = (torch.sum(hidden.float() * m, dim=1)
                  / torch.clamp(torch.sum(m, dim=1), min=1e-9))
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)
