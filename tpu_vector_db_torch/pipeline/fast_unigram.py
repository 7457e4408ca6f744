"""Native Unigram/SentencePiece tokenizer (ctypes bridge to
native/unigram.cpp).

Counterpart of ``tpu_vector_db/pipeline/fast_unigram.py``, over the
same ``native/libvdbuni-<sha>.so`` (g++ at first use, through
``ops/_build.py``). Unlike the WordPiece fast path this one is NOT
ASCII-gated: Unicode normalization runs in Python
(``unicodedata.normalize`` is one C call per text) and the C++ side works
on the normalized UTF-8 bytes, so multilingual input stays on the native
path.

Python fallback cases (route to the inherited implementation):
- tokenizer.json configs outside the supported set (pre-tokenizers other
  than [WhitespaceSplit?, Metaspace?], multi-char Metaspace replacement);
- texts containing NUL (breaks the blob protocol);
- texts containing non-ASCII whitespace when WhitespaceSplit is configured
  (Python ``str.split()`` splits on U+0085/U+00A0/... which the byte-level
  splitter does not);
- no C++ compiler (``native_available()`` is then False)."""

from __future__ import annotations

import ctypes
import logging
import re

import numpy as np

from tpu_vector_db_torch.ops._build import NATIVE_DIR, Library
from tpu_vector_db_torch.pipeline.unigram import UnigramTokenizer

logger = logging.getLogger(__name__)

# unicode whitespace outside the ASCII plane (chars where str.isspace() is
# True but the native byte-level splitter won't split)
_EXOTIC_WS = re.compile("[\\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029\\u202f\\u205f\\u3000]")

_PREPEND = {"never": 0, "always": 1, "first": 2}


def _register(lib: ctypes.CDLL) -> None:
    lib.un_create.restype = ctypes.c_void_p
    lib.un_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32]
    lib.un_destroy.argtypes = [ctypes.c_void_p]
    lib.un_tokenize.restype = ctypes.c_int32
    lib.un_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.un_encode_batch.restype = ctypes.c_int32
    lib.un_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]


LIBRARY = Library(NATIVE_DIR / "unigram.cpp", _register, name="libvdbuni")


def native_available() -> bool:
    return LIBRARY.load() is not None


def _parse_pretok(pre_tokenizers: list[dict]):
    """Map the tokenizer.json pre-tokenizer sequence onto the native
    pipeline flags; None if the config is outside the supported set."""
    ws, ms = False, None
    for p in pre_tokenizers:
        t = p.get("type")
        if t == "WhitespaceSplit" and not ws and ms is None:
            ws = True
        elif t == "Metaspace" and ms is None:
            ms = p
        else:
            return None
    if ms is None:
        if ws:
            return ws, 0, 0, 0, "▁"
        return False, 0, 0, 0, "▁"  # bare sentencepiece
    rep = ms.get("replacement", "▁")
    if len(rep) != 1:
        return None  # marker-start split walks single codepoints
    scheme = ms.get("prepend_scheme",
                    "always" if ms.get("add_prefix_space", True)
                    else "never")
    if scheme not in _PREPEND:
        return None
    split = 1 if ms.get("split", True) else 0
    return ws, 1, split, _PREPEND[scheme], rep


class FastUnigramTokenizer(UnigramTokenizer):
    """Drop-in UnigramTokenizer: C++ fast path for the supported
    tokenizer.json configs (every XLM-R/e5-style checkpoint), the inherited
    Python implementation for everything else."""

    def __init__(self, tokenizer_json: str | Path) -> None:
        super().__init__(tokenizer_json)
        self._h = None
        self._route_ws = False
        lib = LIBRARY.load()
        if lib is None:
            return
        flags = _parse_pretok(self._pre_tokenizers)
        if flags is None:
            logger.info("unsupported pre-tokenizer config; native unigram "
                        "disabled for this tokenizer")
            return
        ws, metaspace, split, prepend, rep = flags
        n = len(self.vocab)
        # ids must be dense 0..n-1 in vocab order (tokenizer.json's vocab
        # array guarantees it — ids are assigned by position)
        pieces = sorted(self.vocab.items(), key=lambda kv: kv[1])
        if not pieces or pieces[0][1] != 0 or pieces[-1][1] != n - 1:
            return
        blob = b"\0".join(p.encode("utf-8") for p, _ in pieces) + b"\0"
        scores = np.array([self.scores[p] for p, _ in pieces], np.float64)
        marker = rep.encode("utf-8")
        self._h = lib.un_create(
            blob, len(blob), n,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            marker, len(marker), float(self._unk_score),
            self.unk_id, self.cls_id if self.cls_id is not None else 0,
            self.sep_id if self.sep_id is not None else 0, self.pad_id,
            int(ws), metaspace, split, prepend)
        self._lib = lib
        self._route_ws = ws

    def __del__(self):  # noqa: D105
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.un_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

    @property
    def native(self) -> bool:
        return self._h is not None

    def _native_ok(self, text: str) -> bool:
        if "\0" in text:
            return False
        if self._route_ws and _EXOTIC_WS.search(text):
            return False
        return True

    def _has_added(self, raw: str) -> bool:
        # embedded added/special tokens split the input BEFORE
        # normalization (unigram.py tokenize_ids) — Python handles those;
        # checked on the RAW text because normalizers may rewrite it
        return self._added_re is not None and \
            self._added_re.search(raw) is not None

    def tokenize_ids(self, text: str) -> list[int]:
        if self._h is None or self._has_added(text):
            return super().tokenize_ids(text)
        norm = self.normalize(text)
        if not self._native_ok(norm):
            return super().tokenize_ids(text)
        raw = norm.encode("utf-8")
        cap = max(2 * len(raw), 8)
        out = np.empty(cap, np.int32)
        n = self._lib.un_tokenize(
            self._h, raw, len(raw),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n > cap:  # can't happen (≥1 byte per id) — belt and braces
            return super().tokenize_ids(text)
        return out[:n].tolist()

    def encode_batch(self, texts: list[str], seq_len: int):
        if seq_len < 2:
            # the C++ writer would compute body = seq_len - 2 < 0 and
            # write one int32 BEFORE the output buffer
            raise ValueError("seq_len must be >= 2 (<s> + </s> framing)")
        if self._h is None or any(self._has_added(t) for t in texts):
            return super().encode_batch(texts, seq_len)
        norms = [self.normalize(t) for t in texts]
        if not all(self._native_ok(t) for t in norms):
            return super().encode_batch(texts, seq_len)
        blob = b"\0".join(t.encode("utf-8") for t in norms) + b"\0"
        n = len(texts)
        ids = np.empty((n, seq_len), np.int32)
        mask = np.empty((n, seq_len), np.int32)
        rc = self._lib.un_encode_batch(
            self._h, blob, len(blob), n, seq_len,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            return super().encode_batch(texts, seq_len)
        return ids, mask
