"""The port's MPNet encoder against the JAX package's.

The relative-position bucket must equal the JAX function for every
distance |n| <= 1024 (it indexes a table: no tolerance). The forward is
held as tests/test_torch_bert.py holds BERT's, on an HF-layout MPNet
checkpoint written from numpy (``pytorch_model.bin`` or
``model.safetensors`` + ``config.json`` + an MPNet-framed ``vocab.txt``):
float32 pooled embeddings within 1e-5, bfloat16 by cosine >= 0.9999, the
int8/int4 trees byte for byte (the (32, heads) bias table stays float32).
"""

import numpy as np
import pytest
import torch

from test_torch_bert import (BF16_COS, F32_TOL, STD, _dense, _ln,
                             assert_trees_equal, cosines, write_checkpoint)

VOCAB_WORDS = [
    "<s>", "<pad>", "</s>", "[UNK]", "<mask>",
    "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
    "over", "lazy", "dog", "cat", "run", "##ner", "un", "##believ",
    "##able", "hello", "world", "!", "?", ",", ".", "'", "don", "t",
    "2", "##0", "##2", "##4", "a", "##a", "b", "##b", "c", "##c",
    "temperature", "vector", "data", "##base", "search", "engine",
]

TEXTS = ["the quick brown fox jumps over the lazy dog", "hello world !",
         "unbelievable runner running 2024", "vector database search", ""]


def mpnet_state(seed, vocab, hidden=32, layers=2, inter=64, positions=64,
                heads=4, buckets=32, std=STD, prefix="mpnet."):
    """HF MPNetModel keys, numpy float32."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, rows in (("word_embeddings", vocab),
                       ("position_embeddings", positions)):
        sd[f"embeddings.{name}.weight"] = (
            std * rng.standard_normal((rows, hidden))).astype(np.float32)
    _ln(rng, sd, "embeddings.LayerNorm", hidden)
    sd["encoder.relative_attention_bias.weight"] = (
        rng.standard_normal((buckets, heads))).astype(np.float32)
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for part in ("q", "k", "v", "o"):
            _dense(rng, sd, f"{p}.attention.attn.{part}", hidden, hidden,
                   std)
        _ln(rng, sd, f"{p}.attention.LayerNorm", hidden)
        _dense(rng, sd, f"{p}.intermediate.dense", inter, hidden, std)
        _dense(rng, sd, f"{p}.output.dense", hidden, inter, std)
        _ln(rng, sd, f"{p}.output.LayerNorm", hidden)
    return {prefix + k: v for k, v in sd.items()}


def mpnet_config(vocab, hidden=32, layers=2, heads=4, inter=64,
                 positions=64):
    return {"model_type": "mpnet", "vocab_size": vocab,
            "hidden_size": hidden, "num_hidden_layers": layers,
            "num_attention_heads": heads, "intermediate_size": inter,
            "max_position_embeddings": positions, "layer_norm_eps": 1e-5,
            "hidden_act": "gelu", "relative_attention_num_buckets": 32,
            "pad_token_id": 1}


def make_mpnet_dir(d, fmt="bin", seed=2):
    write_checkpoint(d, mpnet_config(len(VOCAB_WORDS)),
                     mpnet_state(seed, len(VOCAB_WORDS)), fmt)
    (d / "vocab.txt").write_text("\n".join(VOCAB_WORDS) + "\n",
                                 encoding="utf-8")
    return d


@pytest.fixture(scope="module")
def mpnet_dir(tmp_path_factory):
    return make_mpnet_dir(tmp_path_factory.mktemp("tmpnet"))


def ids_and_mask(d, texts=TEXTS, seq=16):
    from tpu_vector_db.pipeline.wordpiece import WordPieceTokenizer
    tok = WordPieceTokenizer(d / "vocab.txt", pad_token="<pad>",
                             cls_token="<s>", sep_token="</s>",
                             unk_token="[UNK]")
    return tok.encode_batch(texts, seq_len=seq)


def both(d, dtype="float32", quantized=False, bits=8):
    import jax.numpy as jnp

    from tpu_vector_db.pipeline import mpnet as jmpnet
    from tpu_vector_db_torch.pipeline import mpnet as tmpnet
    jcfg = jmpnet.MPNetConfig.from_hf_dir(d)
    jparams = jmpnet.load_hf_params(d, jcfg)
    if quantized:
        jparams = jmpnet.quantize_params(jparams, bits=bits)
    jmod = jmpnet.make_mpnet_module(
        jcfg, compute_dtype=jnp.float32 if dtype == "float32"
        else jnp.bfloat16, quantized=quantized)
    model = tmpnet.load_module(
        tmpnet.make_mpnet_module(tmpnet.MPNetConfig.from_hf_dir(d), dtype,
                                 quantized), jparams, "cpu")
    return jmod, jparams, model


def pooled(jmod, jparams, model, ids, mask, pooling="mean"):
    from test_torch_bert import jax_pooled, port_pooled
    return (port_pooled(model, ids, mask, pooling),
            jax_pooled(jmod, jparams, ids, mask, pooling))


def test_bucket_equal_to_jax():
    import jax.numpy as jnp

    from tpu_vector_db.pipeline.mpnet import relative_position_bucket as jb
    from tpu_vector_db_torch.pipeline.mpnet import relative_position_bucket
    rel = np.arange(-1024, 1025, dtype=np.int64)
    want = np.asarray(jb(jnp.asarray(rel)))
    got = relative_position_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bucket_matrix_is_cached_per_length(mpnet_dir):
    _, _, model = both(mpnet_dir)
    a = model._bucket_matrix(16, "cpu")
    assert model._bucket_matrix(16, "cpu") is a
    pos = np.arange(16)
    from tpu_vector_db_torch.pipeline.mpnet import relative_position_bucket
    want = relative_position_bucket(
        torch.from_numpy(pos[None, :] - pos[:, None])).numpy()
    np.testing.assert_array_equal(a.numpy(), want)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_hf_params_equal_to_jax(tmp_path, fmt):
    from tpu_vector_db.pipeline import mpnet as jmpnet
    from tpu_vector_db_torch.pipeline import mpnet as tmpnet
    d = make_mpnet_dir(tmp_path, fmt)
    want = jmpnet.load_hf_params(d, jmpnet.MPNetConfig.from_hf_dir(d))
    got = tmpnet.load_hf_params(d, tmpnet.MPNetConfig.from_hf_dir(d))
    assert_trees_equal(got, want)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_forward_f32_matches_jax(mpnet_dir, pooling):
    ids, mask = ids_and_mask(mpnet_dir)
    got, want = pooled(*both(mpnet_dir), ids, mask, pooling)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, "int8", "int4"])
def test_forward_bf16_matches_jax(mpnet_dir, quant):
    ids, mask = ids_and_mask(mpnet_dir)
    got, want = pooled(*both(mpnet_dir, "bfloat16", quant,
                             4 if quant == "int4" else 8), ids, mask)
    assert np.all(cosines(got, want) >= BF16_COS)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_and_forward_match_jax(mpnet_dir, bits):
    from tpu_vector_db_torch.pipeline import mpnet as tmpnet
    quant = "int4" if bits == 4 else "int8"
    jmod, jparams, model = both(mpnet_dir, quantized=quant, bits=bits)
    got_tree = tmpnet.quantize_params(tmpnet.load_hf_params(
        mpnet_dir, tmpnet.MPNetConfig.from_hf_dir(mpnet_dir)), bits=bits)
    assert_trees_equal(got_tree["params"], jparams["params"])
    assert got_tree["params"]["rel_bias"]["embedding"].dtype == np.float32
    assert model.rel_bias.weight.dtype == torch.float32
    ids, mask = ids_and_mask(mpnet_dir)
    got, want = pooled(jmod, jparams, model, ids, mask)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_loader_rejects_layer_mismatch(mpnet_dir):
    from tpu_vector_db_torch.pipeline import mpnet as tmpnet
    cfg = tmpnet.MPNetConfig.from_hf_dir(mpnet_dir)
    cfg.num_hidden_layers = 3
    with pytest.raises(ValueError, match="layers"):
        tmpnet.load_hf_params(mpnet_dir, cfg)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_encoder_matches_jax(mpnet_dir, quant):
    """create_encoder('hf:<dir>') dispatches on model_type=mpnet (<s>/</s>
    framing, the max length clamped to positions - 2) as the JAX encoder
    does, and embeds alike."""
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    enc = create_encoder(f"hf:{mpnet_dir}", device="cpu", dtype="float32",
                         quantize=quant)
    jenc = jcreate(f"hf:{mpnet_dir}", dtype="float32", quantize=quant)
    corpus = ["the quick brown fox", "lazy dog", "hello world",
              "vector database search", " ".join(["fox"] * 80)]
    got, want = enc.encode(corpus), jenc.encode(corpus)
    assert enc.config.max_sequence_length == 62
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("quant,gate", [("int8", 0.99), ("int4", 0.98)])
def test_quantized_gate_against_f32(mpnet_dir, quant, gate):
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    texts = ["the quick brown fox", "vector database search engine"]
    ref = create_encoder(f"hf:{mpnet_dir}", device="cpu", dtype="float32")
    q = create_encoder(f"hf:{mpnet_dir}", device="cpu", dtype="float32",
                       quantize=quant)
    assert np.all(np.sum(ref.encode(texts) * q.encode(texts), -1) >= gate)


@pytest.mark.gpu
def test_forward_on_card_matches_cpu(mpnet_dir):
    """float32 on the card within 1e-5 of the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    texts = TEXTS * 9
    cpu = create_encoder(f"hf:{mpnet_dir}", device="cpu", dtype="float32")
    card = create_encoder(f"hf:{mpnet_dir}", device="cuda", dtype="float32")
    np.testing.assert_allclose(card.encode(texts), cpu.encode(texts),
                               atol=F32_TOL, rtol=0)
