"""The port's BERT / RoBERTa / XLM-R encoder against the JAX package's.

Checkpoints are written in HF layout from numpy made from a seed (weights
N(0, 0.1), LayerNorms near 1 / 0): ``pytorch_model.bin`` by ``torch.save``
of HF-keyed tensors, ``model.safetensors`` by the ``safetensors`` package,
plus ``config.json``; no test needs ``transformers``. The same ids go
through the JAX module (``make_bert_module`` + ``load_hf_params``) and
the port's (``make_bert_module`` + ``load_module``), on the CPU.

Tolerances:
- float32 forward, pooled and L2-normalised: 1e-5 absolute (measured
  <= 1.8e-7). Both sum in float32 in another order, and the port's
  LayerNorm takes the two-pass variance where Flax takes E[x²] − E[x]²;
- bfloat16: cosine >= 0.9999 between the packages (measured >= 0.99998).
  Both round at the same points, but a bf16 rounding of an intermediate
  that lands on the other side of a rounding edge moves an element by one
  bf16 ulp (2^-8 relative), and XLA's CPU GELU on bf16 rounds inside the
  op where torch rounds once;
- int8 / int4 trees: byte for byte equal (the same numpy quantizer);
  their forwards as the float ones above.
"""

import json
import struct

import numpy as np
import pytest
import torch

VOCAB_WORDS = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
    "over", "lazy", "dog", "cat", "run", "##ner", "un", "##believ",
    "##able", "hello", "world", "!", "?", ",", ".", "'", "don", "t",
    "2", "##0", "##2", "##4", "a", "##a", "b", "##b", "c", "##c",
    "temperature", "vector", "data", "##base", "search", "engine",
    "天", "気",
]

TEXTS = ["the quick brown fox jumps over the lazy dog",
         "hello world !", "unbelievable runner running 2024",
         "vector database search engine", ""]

F32_TOL = 1e-5
BF16_COS = 0.9999
STD = 0.1


# ------------------------------------------------ checkpoints from numpy

def _dense(rng, sd, name, out_f, in_f, std=STD):
    sd[f"{name}.weight"] = (std * rng.standard_normal((out_f, in_f))
                            ).astype(np.float32)
    sd[f"{name}.bias"] = (0.02 * rng.standard_normal(out_f)
                          ).astype(np.float32)


def _ln(rng, sd, name, h):
    sd[f"{name}.weight"] = (1 + 0.1 * rng.standard_normal(h)
                            ).astype(np.float32)
    sd[f"{name}.bias"] = (0.1 * rng.standard_normal(h)).astype(np.float32)


def bert_state(seed, vocab, hidden=32, layers=2, inter=64, positions=64,
               types=2, std=STD, prefix=""):
    """HF BertModel / XLMRobertaModel keys, numpy float32."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, rows in (("word_embeddings", vocab),
                       ("position_embeddings", positions),
                       ("token_type_embeddings", types)):
        sd[f"embeddings.{name}.weight"] = (
            std * rng.standard_normal((rows, hidden))).astype(np.float32)
    _ln(rng, sd, "embeddings.LayerNorm", hidden)
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for part in ("query", "key", "value"):
            _dense(rng, sd, f"{p}.attention.self.{part}", hidden, hidden,
                   std)
        _dense(rng, sd, f"{p}.attention.output.dense", hidden, hidden, std)
        _ln(rng, sd, f"{p}.attention.output.LayerNorm", hidden)
        _dense(rng, sd, f"{p}.intermediate.dense", inter, hidden, std)
        _dense(rng, sd, f"{p}.output.dense", hidden, inter, std)
        _ln(rng, sd, f"{p}.output.LayerNorm", hidden)
    return {prefix + k: v for k, v in sd.items()}


def write_checkpoint(d, config: dict, state: dict, fmt="bin"):
    """config.json + weights in HF layout."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(config))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   d / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file
        save_file(state, str(d / "model.safetensors"))
    return d


def bert_config(vocab, hidden=32, layers=2, heads=4, inter=64, positions=64,
                model_type="bert", types=2, pad=0):
    return {"model_type": model_type, "vocab_size": vocab,
            "hidden_size": hidden, "num_hidden_layers": layers,
            "num_attention_heads": heads, "intermediate_size": inter,
            "max_position_embeddings": positions, "type_vocab_size": types,
            "layer_norm_eps": 1e-12, "hidden_act": "gelu",
            "pad_token_id": pad}


def make_bert_dir(d, fmt="bin", seed=0, prefix=""):
    write_checkpoint(d, bert_config(len(VOCAB_WORDS)),
                     bert_state(seed, len(VOCAB_WORDS), prefix=prefix), fmt)
    (d / "vocab.txt").write_text("\n".join(VOCAB_WORDS) + "\n",
                                 encoding="utf-8")
    return d


UNIGRAM_PIECES = [
    ("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", -12.0),
    ("▁", -3.0), ("▁the", -2.0), ("▁quick", -4.0), ("▁fox", -3.5),
    ("▁dog", -3.6), ("▁a", -2.5), ("a", -4.0), ("b", -4.2), ("c", -4.4),
    ("th", -5.0), ("e", -3.9), ("▁th", -4.8), ("qu", -5.5), ("ick", -5.2),
    ("▁über", -4.1), ("ü", -5.0), ("ber", -4.9), ("日", -4.5), ("本", -4.6),
    ("日本", -3.8), ("語", -4.7), ("▁日本", -4.2), ("x", -4.3), ("y", -4.4),
    ("z", -4.5), ("▁x", -4.9), ("12", -4.0), ("1", -4.8), ("2", -4.8),
    ("!", -4.0), (",", -4.1), ("▁hello", -3.0), ("▁world", -3.1),
    ("▁vector", -3.3), ("▁search", -3.4), ("▁data", -3.2), ("base", -4.0),
]


def unigram_json(path):
    spec = {"model": {"type": "Unigram", "unk_id": 3,
                      "vocab": [list(p) for p in UNIGRAM_PIECES]},
            "normalizer": {"type": "NFKC"},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "added_tokens": []}
    path.write_text(json.dumps(spec), encoding="utf-8")
    return path


def make_xlmr_dir(d, fmt="bin", seed=1):
    vocab = len(UNIGRAM_PIECES)
    write_checkpoint(
        d, bert_config(vocab, positions=80, model_type="xlm-roberta",
                       types=1, pad=1),
        bert_state(seed, vocab, positions=80, types=1, prefix="roberta."),
        fmt)
    unigram_json(d / "tokenizer.json")
    return d


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    return make_bert_dir(tmp_path_factory.mktemp("tbert"))


@pytest.fixture(scope="module")
def xlmr_dir(tmp_path_factory):
    return make_xlmr_dir(tmp_path_factory.mktemp("txlmr"))


# --------------------------------------------------------------- helpers

def ids_and_mask(d, texts=TEXTS, seq=16):
    from tpu_vector_db.pipeline.unigram import UnigramTokenizer
    from tpu_vector_db.pipeline.wordpiece import WordPieceTokenizer
    tok = (UnigramTokenizer(d / "tokenizer.json")
           if (d / "tokenizer.json").exists()
           else WordPieceTokenizer(d / "vocab.txt"))
    return tok.encode_batch(texts, seq_len=seq)


def jax_pooled(module, params, ids, mask, pooling="mean"):
    import jax.numpy as jnp

    from tpu_vector_db.pipeline import bert as jbert
    hidden = module.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    return np.asarray(jbert.pool_hidden(hidden, jnp.asarray(mask), pooling),
                      np.float32)


def port_pooled(model, ids, mask, pooling="mean"):
    from tpu_vector_db_torch.pipeline import bert as tbert
    m = torch.from_numpy(mask)
    with torch.inference_mode():
        hidden = model(torch.from_numpy(ids), m)
        return tbert.pool_hidden(hidden, m, pooling).numpy()


def both(d, dtype="float32", quantized=False, bits=8):
    """(JAX module, JAX tree, port module) for the checkpoint in d."""
    import jax.numpy as jnp

    from tpu_vector_db.pipeline import bert as jbert
    from tpu_vector_db_torch.pipeline import bert as tbert
    jcfg = jbert.BertConfig.from_hf_dir(d)
    jparams = jbert.load_hf_params(d, jcfg)
    if quantized:
        jparams = jbert.quantize_params(jparams, bits=bits)
    jmod = jbert.make_bert_module(
        jcfg, compute_dtype=jnp.float32 if dtype == "float32"
        else jnp.bfloat16, quantized=quantized)
    tcfg = tbert.BertConfig.from_hf_dir(d)
    model = tbert.load_module(
        tbert.make_bert_module(tcfg, dtype, quantized), jparams, "cpu")
    return jmod, jparams, model


def cosines(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))


def assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k])
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("family", ["bert", "xlmr"])
def test_load_hf_params_equal_to_jax(tmp_path, fmt, family):
    """Both checkpoint formats, with and without a task-model prefix,
    read into the JAX loader's tree, value for value."""
    from tpu_vector_db.pipeline import bert as jbert
    from tpu_vector_db_torch.pipeline import bert as tbert
    d = (make_bert_dir(tmp_path, fmt) if family == "bert"
         else make_xlmr_dir(tmp_path, fmt))
    want = jbert.load_hf_params(d, jbert.BertConfig.from_hf_dir(d))
    got = tbert.load_hf_params(d, tbert.BertConfig.from_hf_dir(d))
    assert_trees_equal(got, want)


def test_safetensors_reader_rejects_unknown_dtype(tmp_path):
    header = json.dumps({"w": {"dtype": "BF16", "shape": [2],
                               "data_offsets": [0, 4]}}).encode()
    p = tmp_path / "model.safetensors"
    p.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 4)
    from tpu_vector_db_torch.pipeline import bert as tbert
    with pytest.raises(ValueError, match="BF16"):
        tbert.read_safetensors(p)


def test_safetensors_reader_reads_every_dtype(tmp_path):
    from safetensors.numpy import save_file

    from tpu_vector_db_torch.pipeline import bert as tbert
    rng = np.random.default_rng(3)
    arrays = {f"t{i}": (100 * rng.standard_normal((3, 2))).astype(dt)
              for i, dt in enumerate((np.float64, np.float32, np.float16,
                                      np.int64, np.int32, np.int16,
                                      np.int8, np.uint8))}
    save_file(arrays, str(tmp_path / "x.safetensors"),
              metadata={"format": "np"})
    got = tbert.read_safetensors(tmp_path / "x.safetensors")
    assert_trees_equal(got, arrays)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("family", ["bert", "xlmr"])
def test_forward_f32_matches_jax(bert_dir, xlmr_dir, family, pooling):
    d = bert_dir if family == "bert" else xlmr_dir
    jmod, jparams, model = both(d)
    ids, mask = ids_and_mask(d)
    want = jax_pooled(jmod, jparams, ids, mask, pooling)
    got = port_pooled(model, ids, mask, pooling)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("family", ["bert", "xlmr"])
def test_forward_bf16_matches_jax(bert_dir, xlmr_dir, family):
    d = bert_dir if family == "bert" else xlmr_dir
    jmod, jparams, model = both(d, dtype="bfloat16")
    ids, mask = ids_and_mask(d)
    cos = cosines(port_pooled(model, ids, mask),
                  jax_pooled(jmod, jparams, ids, mask))
    assert np.all(cos >= BF16_COS), cos


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_equal_jax(bert_dir, bits):
    from tpu_vector_db.pipeline import bert as jbert
    from tpu_vector_db_torch.pipeline import bert as tbert
    jparams = jbert.load_hf_params(bert_dir,
                                   jbert.BertConfig.from_hf_dir(bert_dir))
    want = jbert.quantize_params(jparams, bits=bits)
    got = tbert.quantize_params(
        tbert.load_hf_params(bert_dir, tbert.BertConfig.from_hf_dir(
            bert_dir)), bits=bits)
    assert_trees_equal(got["params"], want["params"])
    assert tbert.param_bytes(got) == jbert.param_bytes(want)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_forward_f32_matches_jax(bert_dir, quant):
    jmod, jparams, model = both(bert_dir, quantized=quant,
                                bits=4 if quant == "int4" else 8)
    ids, mask = ids_and_mask(bert_dir)
    np.testing.assert_allclose(port_pooled(model, ids, mask),
                               jax_pooled(jmod, jparams, ids, mask),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_forward_bf16_matches_jax(xlmr_dir, quant):
    jmod, jparams, model = both(xlmr_dir, "bfloat16", quantized=quant,
                                bits=4 if quant == "int4" else 8)
    ids, mask = ids_and_mask(xlmr_dir)
    cos = cosines(port_pooled(model, ids, mask),
                  jax_pooled(jmod, jparams, ids, mask))
    assert np.all(cos >= BF16_COS), cos


@pytest.mark.parametrize("quant,gate", [("int8", 0.99), ("int4", 0.98)])
def test_quantized_gate_against_f32(bert_dir, quant, gate):
    """The JAX tests' gates (tests/test_bert.py), on the port alone."""
    _, _, ref = both(bert_dir)
    _, _, q = both(bert_dir, quantized=quant,
                   bits=4 if quant == "int4" else 8)
    ids, mask = ids_and_mask(bert_dir)
    cos = cosines(port_pooled(q, ids, mask), port_pooled(ref, ids, mask))
    assert np.all(cos >= gate), cos


def test_module_bytes(bert_dir):
    """A float32 module holds the tree's bytes; int8 about a quarter."""
    from tpu_vector_db_torch.pipeline import bert as tbert
    _, jparams, f32 = both(bert_dir)
    _, _, q8 = both(bert_dir, quantized="int8")
    assert tbert.param_bytes(f32) == tbert.param_bytes(jparams)
    assert tbert.param_bytes(q8) < 0.35 * tbert.param_bytes(f32)


def test_int4_unpack_matches_jax_dequantization():
    """Even input rows in the low nibble: the module's dequantized weight
    is the JAX module's kernel, transposed."""
    from tpu_vector_db.pipeline import bert as jbert
    from tpu_vector_db_torch.pipeline import bert as tbert
    rng = np.random.default_rng(0)
    m = rng.standard_normal((128, 8)).astype(np.float32)
    tree = {"params": {"x": {"kernel": m, "bias": np.zeros(8, np.float32)}}}
    q = jbert.quantize_params(tree, bits=4)["params"]["x"]
    packed, scale = np.asarray(q["kernel_q4"]), np.asarray(q["scale"])
    lo = (packed & 15).astype(np.int32) - 8
    hi = ((packed >> 4) & 15).astype(np.int32) - 8
    want = (np.stack([lo, hi], axis=1).reshape(128, 8).astype(np.float32)
            .reshape(2, 64, 8) * scale[:, None, :]).reshape(128, 8)
    layer = tbert.Int4Linear(128, 8, torch.float32)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           tbert.from_flax_params(
                               {"params": {"x": q}}).items()})
    np.testing.assert_array_equal(layer.dequantized().numpy(), want.T)


def test_roberta_position_ids_match_jax():
    import jax.numpy as jnp

    from tpu_vector_db.pipeline.bert import roberta_position_ids as jpos
    from tpu_vector_db_torch.pipeline.bert import roberta_position_ids
    ids = np.array([[5, 9, 7, 1, 1], [6, 1, 1, 1, 1], [4, 4, 4, 4, 4]])
    mask = (ids != 1).astype(np.int32)
    want = np.asarray(jpos(jnp.asarray(ids), jnp.asarray(mask), 1))
    got = roberta_position_ids(torch.from_numpy(ids),
                               torch.from_numpy(mask), 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_loader_rejects_layer_mismatch(bert_dir):
    from tpu_vector_db_torch.pipeline import bert as tbert
    cfg = tbert.BertConfig.from_hf_dir(bert_dir)
    cfg.num_hidden_layers = 5
    with pytest.raises(ValueError, match="layers"):
        tbert.load_hf_params(bert_dir, cfg)


def test_from_flax_params_takes_jax_arrays(bert_dir):
    """The JAX package's own tree (jax arrays) loads strictly: every
    tensor of the module gets a value and no key is left over."""
    import jax.numpy as jnp

    from tpu_vector_db.pipeline import bert as jbert
    from tpu_vector_db_torch.pipeline import bert as tbert
    tree = jbert.load_hf_params(bert_dir,
                                jbert.BertConfig.from_hf_dir(bert_dir),
                                param_dtype=jnp.float32)
    state = tbert.from_flax_params(tree)
    model = tbert.make_bert_module(tbert.BertConfig.from_hf_dir(bert_dir),
                                   "float32")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)


def encoders(d, **kw):
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    return (jcreate(f"hf:{d}", dtype="float32", **kw),
            create_encoder(f"hf:{d}", device="cpu", dtype="float32", **kw))


@pytest.mark.parametrize("family", ["bert", "xlmr"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encoder_matches_jax(bert_dir, xlmr_dir, family, pooling):
    """create_encoder('hf:<dir>'): the same tokens, embeddings within
    1e-5, the same ranking; the served dimension is the checkpoint's."""
    d = bert_dir if family == "bert" else xlmr_dir
    jenc, enc = encoders(d, pooling=pooling)
    corpus = ["the quick brown fox", "lazy dog", "hello world",
              "vector database search", "temperature data über 日本"]
    want, got = jenc.encode(corpus), enc.encode(corpus)
    assert got.shape == (5, 32) and enc.dimension == 32
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    q, jq = enc.encode(["quick fox jumps"])[0], jenc.encode(
        ["quick fox jumps"])[0]
    np.testing.assert_array_equal(np.argsort(-(got @ q)),
                                  np.argsort(-(want @ jq)))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_encoder_quantized_matches_jax(bert_dir, quant):
    jenc, enc = encoders(bert_dir, quantize=quant)
    texts = ["the quick brown fox", "vector database search engine"]
    np.testing.assert_allclose(enc.encode(texts), jenc.encode(texts),
                               atol=F32_TOL, rtol=0)


def test_bad_quantize_value_rejected(bert_dir):
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    enc = create_encoder(f"hf:{bert_dir}", device="cpu", quantize="int2")
    with pytest.raises(ValueError, match="quantize"):
        enc.load()


def test_overlong_text_keeps_sep(bert_dir, monkeypatch):
    """When max_sequence_length exceeds the largest SEQ bucket, the
    TOKENIZER truncates, keeping the trailing [SEP]."""
    from tpu_vector_db_torch.pipeline import encoders
    monkeypatch.setattr(encoders, "SEQ_BUCKETS", (8, 16))
    enc = encoders.create_encoder(f"hf:{bert_dir}", device="cpu",
                                  dtype="float32", max_sequence_length=64)
    enc.load()
    captured = {}
    orig = enc._forward

    def spy(ids, mask):
        captured["ids"], captured["mask"] = ids.numpy(), mask.numpy()
        return orig(ids, mask)

    enc._forward = spy
    out = enc.encode([" ".join(["quick brown fox"] * 40)])
    assert out.shape[0] == 1
    ids, mask = captured["ids"], captured["mask"]
    assert ids.shape[1] == 16 and ids.dtype == np.int64
    assert ids[0, int(mask[0].sum()) - 1] == enc._tokenizer.sep_id


@pytest.mark.parametrize("family,usable", [("bert", 20), ("xlmr", 18)])
def test_max_length_clamped_to_position_table(tmp_path, family, usable):
    """max_sequence_length shrinks to the position table (RoBERTa-style
    positions start at pad + 1: two rows fewer), as in the JAX encoder.
    A 20-row BERT table under the 32-token bucket: the padded positions
    20-31 fall past the table, where the JAX module's ``jnp.take`` gives
    NaN and the port clamps to the last row (masked out of the pool, so
    the embedding is the live tokens'); the XLM-R rows pad at pad_id and
    agree."""
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    vocab = len(VOCAB_WORDS) if family == "bert" else len(UNIGRAM_PIECES)
    cfg = bert_config(vocab, positions=20,
                      model_type="bert" if family == "bert"
                      else "xlm-roberta", types=2 if family == "bert"
                      else 1, pad=0 if family == "bert" else 1)
    write_checkpoint(tmp_path, cfg, bert_state(
        5, vocab, positions=20, types=cfg["type_vocab_size"]))
    if family == "bert":
        (tmp_path / "vocab.txt").write_text("\n".join(VOCAB_WORDS) + "\n")
    else:
        unigram_json(tmp_path / "tokenizer.json")
    enc = create_encoder(f"hf:{tmp_path}", device="cpu", dtype="float32")
    jenc = jcreate(f"hf:{tmp_path}", dtype="float32")
    enc.load()
    jenc.load()
    assert enc.config.max_sequence_length == usable
    assert jenc.config.max_sequence_length == usable
    long = " ".join(["the quick fox"] * 30)
    got, want = enc.encode([long]), jenc.encode([long])
    assert np.all(np.isfinite(got))
    if family == "bert":
        assert np.all(np.isnan(want))
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_encoder_runs_on_cuda_by_default(bert_dir):
    """Without device=..., the encoder asks for CUDA and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    with pytest.raises(RuntimeError, match="CUDA"):
        create_encoder(f"hf:{bert_dir}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_on_card_matches_cpu(bert_dir, dtype):
    """The module on the card against the same module on the CPU:
    float32 within 1e-5, bfloat16 by cosine (cuBLAS and the CPU round
    bf16 products' sums in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    texts = TEXTS * 7
    cpu = create_encoder(f"hf:{bert_dir}", device="cpu", dtype=dtype)
    card = create_encoder(f"hf:{bert_dir}", device="cuda", dtype=dtype)
    want, got = cpu.encode(texts), card.encode(texts)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    else:
        assert np.all(cosines(got, want) >= BF16_COS)
