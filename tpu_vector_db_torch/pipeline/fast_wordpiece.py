"""Native WordPiece tokenizer (ctypes bridge to native/wordpiece.cpp).

Counterpart of ``tpu_vector_db/pipeline/fast_wordpiece.py``. The
pure-Python WordPiece is the slow host half of an encode call; the C++
path covers ASCII text exactly (same algorithm, byte for byte) and any
text containing a non-ASCII byte routes to the Python tokenizer, so ids
are equal by construction. The library is the JAX loader's:
``native/libvdbtok-<sha>.so``, built by g++ at first use through
``ops/_build.py``. With no compiler every text takes the
Python path; ``native_available()`` and ``FastWordPieceTokenizer.native``
say which path is live."""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from tpu_vector_db_torch.ops._build import NATIVE_DIR, Library
from tpu_vector_db_torch.pipeline.wordpiece import (CLS, PAD, SEP, UNK,
                                                    WordPieceTokenizer)

logger = logging.getLogger(__name__)


def _register(lib: ctypes.CDLL) -> None:
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_tokenize.restype = ctypes.c_int32
    lib.wp_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.wp_encode_batch.restype = ctypes.c_int32
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]


LIBRARY = Library(NATIVE_DIR / "wordpiece.cpp", _register,
                  name="libvdbtok")


def native_available() -> bool:
    return LIBRARY.load() is not None


class FastWordPieceTokenizer(WordPieceTokenizer):
    """Drop-in WordPieceTokenizer: C++ fast path for ASCII texts, the
    inherited Python implementation for everything else (non-ASCII input,
    strip_accents overrides, or when no compiler is available)."""

    def __init__(self, vocab, lowercase: bool = True,
                 strip_accents: bool | None = None,
                 max_input_chars_per_word: int = 100,
                 pad_token: str = PAD, unk_token: str = UNK,
                 cls_token: str = CLS, sep_token: str = SEP) -> None:
        super().__init__(vocab, lowercase=lowercase,
                         strip_accents=strip_accents,
                         max_input_chars_per_word=max_input_chars_per_word,
                         pad_token=pad_token, unk_token=unk_token,
                         cls_token=cls_token, sep_token=sep_token)
        self._h = None
        # accent stripping is a no-op on ASCII, so any strip_accents value
        # is compatible with the ASCII fast path
        lib = LIBRARY.load()
        if lib is not None and max_input_chars_per_word == 100:
            ordered = sorted(self.vocab.items(), key=lambda kv: kv[1])
            # ids must be dense 0..n-1 for the order-is-id blob contract
            # (vocab.txt files always are; hand-built dicts may not be)
            if ordered and ordered[0][1] == 0 \
                    and ordered[-1][1] == len(ordered) - 1:
                blob = b"\0".join(t.encode("utf-8")
                                  for t, _ in ordered) + b"\0"
                self._h = lib.wp_create(
                    blob, len(blob), len(ordered), int(lowercase),
                    self.pad_id, self.unk_id, self.cls_id, self.sep_id)
                self._lib = lib

    def __del__(self):  # noqa: D105
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.wp_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

    @property
    def native(self) -> bool:
        return self._h is not None

    def _tokenize_ids_native(self, text: str) -> list[int] | None:
        if self._h is None or not text.isascii():
            return None
        raw = text.encode("ascii")
        cap = max(len(raw), 8)
        out = np.empty(cap, np.int32)
        n = self._lib.wp_tokenize(
            self._h, raw, len(raw),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n < 0:
            return None
        return out[: min(n, cap)].tolist()

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        ids = self._tokenize_ids_native(text)
        if ids is None:
            return super().encode(text, max_length=max_length)
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: list[str], seq_len: int):
        if seq_len < 2:
            # the C++ writer would compute body = seq_len - 2 < 0 and
            # write one int32 BEFORE the output buffer
            raise ValueError("seq_len must be >= 2 (CLS + SEP framing)")
        # NUL would corrupt the NUL-delimited blob protocol (silently
        # shifting every subsequent row) — route such batches to Python
        if self._h is None or not all(
                t.isascii() and "\0" not in t for t in texts):
            return super().encode_batch(texts, seq_len)
        blob = b"\0".join(t.encode("ascii") for t in texts) + b"\0"
        n = len(texts)
        ids = np.empty((n, seq_len), np.int32)
        mask = np.empty((n, seq_len), np.int32)
        rc = self._lib.wp_encode_batch(
            self._h, blob, len(blob), n, seq_len,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            return super().encode_batch(texts, seq_len)
        return ids, mask

    def tokenize(self, text: str) -> list[str]:
        ids = self._tokenize_ids_native(text)
        if ids is None:
            return super().tokenize(text)
        return [self.ids_to_tokens[i] for i in ids]
