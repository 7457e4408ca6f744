"""The port's encoders (``pipeline/encoders.py``, ``pipeline/prng.py``)
against the JAX package's.

- The hashing encoder's table: ``prng.bits`` equals ``jax.random.bits``
  bit for bit; ``prng.normal`` is ``jax.random.normal`` within 1e-6
  (measured 7.2e-7 at (30522, 384): the last bits of ``log1p`` inside
  XLA's erfinv polynomial), and ``hash-*`` embeddings within 1e-5.
- The transformer encoder on the JAX encoder's own parameters (carried
  across, and read from a ``flax.serialization.to_bytes`` file): float32
  within 1e-5, bfloat16 by cosine >= 0.999 (softmax and GELU on bf16
  logits round inside XLA's ops where torch rounds once).
- The registry, the factory's dispatch, batches past the largest bucket,
  empty texts, and the default device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_bert import F32_TOL, cosines, make_bert_dir

TEXTS = ["hello world", "the tpu matrix hardware", "", "pasta cooking",
         "x " * 70, "don't stop-believing 2024!", "ÜBER café"]
TINY = dict(num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
            vocab_size=1000)


def test_prng_bits_equal_jax():
    import jax

    from tpu_vector_db_torch.pipeline import prng
    for seed, shape in ((0, (1000, 64)), (7, (3, 5, 2)), (123456, (17,))):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
        np.testing.assert_array_equal(prng.bits(seed, shape), want)


def test_hash_table_matches_jax():
    import jax
    import jax.numpy as jnp

    from tpu_vector_db_torch.pipeline import prng
    shape = (30522, 384)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                        jnp.float32))
    got = prng.normal(0, shape).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6
    assert np.mean(got == want) > 0.9


def pair(name, **kw):
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    return jcreate(name, **kw), create_encoder(name, device="cpu", **kw)


@pytest.mark.parametrize("name", ["hash-256", "hash-384"])
def test_hash_embeddings_match_jax(name):
    jenc, enc = pair(name)
    for texts in (TEXTS, ["solo"], [f"text {i} of many" for i in range(200)]):
        got, want = enc.encode(texts), jenc.encode(texts)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_hash_empty_and_semantics():
    _, enc = pair("hash-384")
    out = enc.encode(["", "non-empty"])
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    e = enc.encode(["tpu matrix hardware", "tpu matrix hardware fast",
                    "pasta cooking recipe"])
    assert e[0] @ e[1] > e[0] @ e[2]


def jax_transformer(**kw):
    from tpu_vector_db.pipeline.encoders import create_encoder as jcreate
    jenc = jcreate("minilm-l6-384", **{**TINY, **kw})
    jenc.load()
    return jenc


@pytest.mark.parametrize("dimension", [32, 48])
def test_transformer_carried_params_match_jax(dimension):
    """The JAX encoder's random init carried across: equal embeddings
    (dimension 48 adds the projection Dense)."""
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    jenc = jax_transformer(dimension=dimension, dtype="float32")
    enc = create_encoder("minilm-l6-384", device="cpu", **TINY,
                         dimension=dimension, dtype="float32")
    enc.load_flax_params(jenc._params)
    got, want = enc.encode(TEXTS), jenc.encode(TEXTS)
    assert got.shape == (len(TEXTS), dimension)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_transformer_bf16_matches_jax():
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    jenc = jax_transformer(dimension=32, dtype="bfloat16")
    enc = create_encoder("minilm-l6-384", device="cpu", **TINY,
                         dimension=32, dtype="bfloat16")
    enc.load_flax_params(jenc._params)
    assert np.all(cosines(enc.encode(TEXTS), jenc.encode(TEXTS)) >= 0.999)


def test_transformer_reads_flax_msgpack(tmp_path):
    """checkpoint_path -> a file written by flax.serialization.to_bytes,
    read without flax or msgpack; also a directory holding one."""
    import flax.serialization

    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    jenc = jax_transformer(dimension=48, dtype="float32")
    f = tmp_path / "ckpt" / "state.msgpack"
    f.parent.mkdir()
    f.write_bytes(flax.serialization.to_bytes(jenc._params))
    want = jenc.encode(TEXTS)
    for path in (f, f.parent):
        enc = create_encoder("minilm-l6-384", device="cpu", **TINY,
                             dimension=48, dtype="float32",
                             checkpoint_path=str(path))
        np.testing.assert_allclose(enc.encode(TEXTS), want, atol=F32_TOL,
                                   rtol=0)


def test_msgpack_reader_rejects_what_flax_params_never_hold():
    """Nested maps and arrays of every dtype read back; a value a
    parameter tree does not hold (a float), another ext type, trailing
    bytes and a truncated file raise."""
    import flax.serialization as fs

    from tpu_vector_db_torch.pipeline.encoders import read_flax_msgpack
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((70, 9)).astype(np.float32),
                  "i8": np.arange(-3, 3, dtype=np.int8)},
            "b": np.zeros((0, 4), np.float64), "s": np.ones(3, np.int64)}
    got = read_flax_msgpack(fs.msgpack_serialize(tree))
    assert set(got) == {"a", "b", "s"} and set(got["a"]) == {"w", "i8"}
    for want, have in ((tree["a"]["w"], got["a"]["w"]),
                       (tree["a"]["i8"], got["a"]["i8"]),
                       (tree["b"], got["b"]), (tree["s"], got["s"])):
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(have, want)
    raw = fs.msgpack_serialize({"x": np.ones(2, np.float32)})
    for bad, what in ((fs.msgpack_serialize({"f": 1.5}), "type byte"),
                      (fs.msgpack_serialize({"c": 1 + 2j}), "ext type"),
                      (raw + b"\0", "trailing"), (raw[:-3], "truncated")):
        with pytest.raises(ValueError, match=what):
            read_flax_msgpack(bad)


def test_registry_equals_jax():
    from tpu_vector_db.pipeline.encoders import (
        BATCH_BUCKETS as JB, EMBEDDING_MODEL_REGISTRY as JREG,
        SEQ_BUCKETS as JS)
    from tpu_vector_db_torch.pipeline.encoders import (
        BATCH_BUCKETS, EMBEDDING_MODEL_REGISTRY, SEQ_BUCKETS)
    assert (BATCH_BUCKETS, SEQ_BUCKETS) == (JB, JS)
    assert list(EMBEDDING_MODEL_REGISTRY) == list(JREG)
    for name, cfg in EMBEDDING_MODEL_REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JREG[name])


def test_factory_dispatch(tmp_path):
    from tpu_vector_db_torch.pipeline import encoders as E
    d = make_bert_dir(tmp_path / "bert")
    assert type(E.create_encoder("hash-256", device="cpu")) is \
        E.HashingEncoder
    assert type(E.create_encoder("bge-small-384", device="cpu")) is \
        E.TransformerEncoder
    assert type(E.create_encoder(f"hf:{d}", device="cpu")) is E.BertEncoder
    enc = E.create_encoder("bge-base-768", device="cpu",
                           checkpoint_path=str(d), pooling="cls")
    assert type(enc) is E.BertEncoder and enc.pooling == "cls"
    with pytest.raises(KeyError):
        E.create_encoder("nope-123", device="cpu")


def test_stats_and_warmup():
    _, enc = pair("hash-256")
    assert enc.warmup()["warmed"]
    enc.encode(["x", "y"])
    s = enc.get_stats()
    assert s["texts"] == 3 and s["batches"] == 2 and s["dimension"] == 256
    assert s["model"] == "hash-256" and s["texts_per_second"] > 0


def test_encoders_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    for name in ("hash-384", "minilm-l6-384"):
        with pytest.raises(RuntimeError, match="CUDA"):
            create_encoder(name)


@pytest.mark.gpu
def test_hash_and_transformer_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_vector_db_torch.pipeline.encoders import create_encoder
    for name, kw in (("hash-384", {}),
                     ("minilm-l6-384", {**TINY, "dtype": "float32"})):
        cpu = create_encoder(name, device="cpu", **kw)
        card = create_encoder(name, device="cuda", **kw)
        np.testing.assert_allclose(card.encode(TEXTS), cpu.encode(TEXTS),
                                   atol=F32_TOL, rtol=0)
