"""The port's tokenizers against the JAX package's, id for id.

WordPiece (BERT and MPNet framing) and Unigram (hand-built scored vocabs,
Metaspace with and without WhitespaceSplit, and one trained by the Rust
``tokenizers`` package as tests/test_multilingual.py trains it), each
through the port's Python tokenizer and its native fast path (the same
``native/*.cpp`` built into the same ``native/libvdb*-<sha>.so`` as the
JAX loader builds), against the JAX package's Python tokenizer (itself
golden against HF's tokenizers in tests/test_bert.py and
tests/test_multilingual.py). A hypothesis fuzz covers ASCII, punctuation,
whitespace, NUL and non-ASCII text. Ids are integers: no tolerance.
"""

import json
import string

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_bert import UNIGRAM_PIECES, VOCAB_WORDS, unigram_json
from test_torch_mpnet import VOCAB_WORDS as MPNET_WORDS

TEXTS = [
    "The quick brown fox jumps over the lazy dog!",
    "Hello, world. Don't.",
    "unbelievable runner running 2024",
    "vector database search engine",
    "UNKNOWNWORDXYZ temperature",
    "  whitespace\t\tand\nnewlines  ",
    "天気 cjk handling",
    "",
    "punct!!!???...",
    "a.b.c a'b",
    "x" * 150,
    "café résumé über ß",
    "the\0quick fox",
]

UNIGRAM_TEXTS = [
    "the quick fox", "the quick brown fox jumps over the lazy dog",
    "   leading and trailing   spaces   ", "über café japan 日本語",
    "numbers 123 and 12321", "punct!,!x", "", " ", "a", "▁pre▁marked",
    "tabs\tand\nnewlines", "straße über caf és", "ＡＢＣ ½ ﬁ",
    "mixed 日本 and ascii xyz", "!,!", "x" * 200, "nbsp\xa0split",
    "hello world vector search database",
]

MPNET_SPECIALS = {"pad_token": "<pad>", "cls_token": "<s>",
                  "sep_token": "</s>", "unk_token": "[UNK]"}

FUZZ = st.text(alphabet=string.ascii_letters + string.digits
               + string.punctuation + " \t\n\0" + "éüß日本語天気▁ＡＢ½\xa0",
               max_size=80)


def vocab_file(tmp_path_factory, words, name):
    p = tmp_path_factory.mktemp(name) / "vocab.txt"
    p.write_text("\n".join(words) + "\n", encoding="utf-8")
    return p


@pytest.fixture(scope="module")
def wordpiece(tmp_path_factory):
    """{family: (port Python, port native, JAX Python)}."""
    from tpu_vector_db.pipeline.wordpiece import WordPieceTokenizer as J
    from tpu_vector_db_torch.pipeline.fast_wordpiece import \
        FastWordPieceTokenizer
    from tpu_vector_db_torch.pipeline.wordpiece import WordPieceTokenizer
    out = {}
    for fam, words, kw in (("bert", VOCAB_WORDS, {}),
                           ("mpnet", MPNET_WORDS, MPNET_SPECIALS)):
        p = vocab_file(tmp_path_factory, words, fam)
        out[fam] = (WordPieceTokenizer(p, **kw),
                    FastWordPieceTokenizer(p, **kw), J(p, **kw))
    return out


def unigram_specs(d):
    """tokenizer.json files: Metaspace, WhitespaceSplit + Metaspace, and
    a pre-tokenizer the native path does not take."""
    plain = unigram_json(d / "metaspace.json")
    spec = json.loads(plain.read_text())
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁",
         "prepend_scheme": "always", "split": True}]}
    ws = d / "ws_metaspace.json"
    ws.write_text(json.dumps(spec), encoding="utf-8")
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
         "split": False}, {"type": "WhitespaceSplit"}]}
    odd = d / "unsupported.json"
    odd.write_text(json.dumps(spec), encoding="utf-8")
    return {"metaspace": plain, "ws_metaspace": ws, "unsupported": odd}


@pytest.fixture(scope="module")
def unigram(tmp_path_factory):
    """{spec: (port Python, port native, JAX Python)}."""
    from tpu_vector_db.pipeline.unigram import UnigramTokenizer as J
    from tpu_vector_db_torch.pipeline.fast_unigram import \
        FastUnigramTokenizer
    from tpu_vector_db_torch.pipeline.unigram import UnigramTokenizer
    specs = unigram_specs(tmp_path_factory.mktemp("uni"))
    return {name: (UnigramTokenizer(p), FastUnigramTokenizer(p), J(p))
            for name, p in specs.items()}


def needs_native():
    from tpu_vector_db_torch.pipeline import fast_unigram, fast_wordpiece
    if not (fast_wordpiece.native_available()
            and fast_unigram.native_available()):
        pytest.skip("no C++ compiler: the native paths are not built")


def test_native_paths_are_live_and_shared_with_jax():
    """The port loads the very library files the JAX loader builds."""
    needs_native()
    from tpu_vector_db.pipeline import fast_unigram as jfu
    from tpu_vector_db.pipeline import fast_wordpiece as jfw
    from tpu_vector_db_torch.pipeline import fast_unigram, fast_wordpiece
    assert fast_wordpiece.LIBRARY.load()._name == jfw._load()._name
    assert fast_unigram.LIBRARY.load()._name == jfu._load()._name


@pytest.mark.parametrize("path", [0, 1], ids=["python", "native"])
@pytest.mark.parametrize("fam", ["bert", "mpnet"])
def test_wordpiece_ids_equal_jax(wordpiece, fam, path):
    if path:
        needs_native()
    tok, ref = wordpiece[fam][path], wordpiece[fam][2]
    assert not path or tok.native
    for text in TEXTS:
        for max_length in (None, 8, 32):
            assert tok.encode(text, max_length=max_length) == \
                ref.encode(text, max_length=max_length), text
        assert tok.tokenize(text) == ref.tokenize(text), text
    for seq in (2, 8, 16):
        got, want = tok.encode_batch(TEXTS, seq), ref.encode_batch(TEXTS,
                                                                   seq)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    ids = ref.encode("the quick brown fox")
    assert tok.decode(ids) == ref.decode(ids)
    assert (tok.pad_id, tok.cls_id, tok.sep_id, tok.unk_id) == \
        (ref.pad_id, ref.cls_id, ref.sep_id, ref.unk_id)


@pytest.mark.parametrize("path", [0, 1], ids=["python", "native"])
@pytest.mark.parametrize("spec", ["metaspace", "ws_metaspace",
                                  "unsupported"])
def test_unigram_ids_equal_jax(unigram, spec, path):
    if path:
        needs_native()
    tok, ref = unigram[spec][path], unigram[spec][2]
    assert not path or tok.native == (spec != "unsupported")
    for text in UNIGRAM_TEXTS:
        assert tok.tokenize_ids(text) == ref.tokenize_ids(text), text
        assert tok.encode(text, max_length=6) == ref.encode(text, 6), text
        assert tok.decode(ref.encode(text)) == ref.decode(ref.encode(text))
    for seq in (2, 8, 32):
        got = tok.encode_batch(UNIGRAM_TEXTS, seq)
        want = ref.encode_batch(UNIGRAM_TEXTS, seq)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_unigram_trained_by_rust_tokenizers(tmp_path):
    """A tokenizer.json trained by the Rust library (XLM-R specials,
    NFKC, Metaspace), as tests/test_multilingual.py trains it."""
    tokenizers = pytest.importorskip("tokenizers")
    from tpu_vector_db.pipeline.unigram import UnigramTokenizer as J
    from tpu_vector_db_torch.pipeline.fast_unigram import \
        FastUnigramTokenizer
    from tpu_vector_db_torch.pipeline.unigram import UnigramTokenizer
    corpus = ["the quick brown fox jumps over the lazy dog",
              "vector databases index embeddings for similarity search",
              "züge fahren schnell durch die nacht",
              "la recherche vectorielle est rapide"] * 10
    tok = tokenizers.Tokenizer(tokenizers.models.Unigram())
    tok.normalizer = tokenizers.normalizers.NFKC()
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always")
    tok.train_from_iterator(corpus, tokenizers.trainers.UnigramTrainer(
        vocab_size=120, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        unk_token="<unk>"))
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    ref = J(path)
    for mine in (UnigramTokenizer(path), FastUnigramTokenizer(path)):
        for text in UNIGRAM_TEXTS + corpus[:4]:
            assert mine.tokenize_ids(text) == ref.tokenize_ids(text), text


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=FUZZ)
def test_fuzz_equal_jax(wordpiece, unigram, text):
    """Every path of every tokenizer gives the JAX Python tokenizer's ids
    on arbitrary text (the native paths fall back where they must)."""
    for fam in ("bert", "mpnet"):
        py, fast, ref = wordpiece[fam]
        want = ref.encode(text, max_length=24)
        assert py.encode(text, max_length=24) == want
        assert fast.encode(text, max_length=24) == want
        np.testing.assert_array_equal(fast.encode_batch([text, "x"], 12)[0],
                                      ref.encode_batch([text, "x"], 12)[0])
    for spec in ("metaspace", "ws_metaspace"):
        py, fast, ref = unigram[spec]
        want = ref.tokenize_ids(text)
        assert py.tokenize_ids(text) == want
        assert fast.tokenize_ids(text) == want
        np.testing.assert_array_equal(fast.encode_batch([text, "a"], 12)[0],
                                      ref.encode_batch([text, "a"], 12)[0])


def test_seq_len_below_framing_rejected(wordpiece, unigram):
    needs_native()
    with pytest.raises(ValueError, match="seq_len"):
        wordpiece["bert"][1].encode_batch(["the fox"], seq_len=1)
    with pytest.raises(ValueError, match="seq_len"):
        unigram["metaspace"][1].encode_batch(["the fox"], seq_len=1)


def test_unigram_rejects_non_unigram_json(tmp_path):
    from tpu_vector_db_torch.pipeline.unigram import UnigramTokenizer
    bad = tmp_path / "tokenizer.json"
    bad.write_text(json.dumps({"model": {"type": "BPE", "vocab": {}}}))
    with pytest.raises(ValueError, match="Unigram"):
        UnigramTokenizer(bad)


def test_wordpiece_missing_special_rejected(tmp_path):
    from tpu_vector_db_torch.pipeline.wordpiece import WordPieceTokenizer
    p = tmp_path / "vocab.txt"
    p.write_text("the\nfox\n")
    with pytest.raises(ValueError, match="special"):
        WordPieceTokenizer(p)


def test_unigram_piece_table_matches(unigram):
    """Framing ids and vocab as the JAX tokenizer reads them."""
    tok, _, ref = unigram["metaspace"]
    assert len(UNIGRAM_PIECES) == tok.vocab_size == ref.vocab_size
    assert (tok.cls_id, tok.sep_id, tok.pad_id, tok.unk_id) == \
        (ref.cls_id, ref.sep_id, ref.pad_id, ref.unk_id)
