"""Unigram (SentencePiece-style) tokenizer — tokenizer.json-driven, no deps.

A copy of ``tpu_vector_db/pipeline/unigram.py`` (pure Python, no JAX).
XLM-RoBERTa checkpoints (multilingual-e5-*) tokenize with a
SentencePiece **Unigram** LM, not WordPiece. This module implements that
family from the HF fast-tokenizer ``tokenizer.json`` every such
checkpoint ships: normalization (NFKC et al.), Metaspace
pre-tokenization (whitespace split, "▁" word-boundary marker), and
Viterbi maximum-likelihood segmentation over the scored vocab, with HF's
unknown handling (per-character unk at min_score - 10, consecutive unks
fused). ``tests/test_torch_tokenizers.py`` holds it id for id against
the JAX package's tokenizer."""

from __future__ import annotations

import json
import logging
import unicodedata
from pathlib import Path

logger = logging.getLogger(__name__)

METASPACE = "▁"  # ▁
_UNK_PENALTY = 10.0   # HF tokenizers kUnkPenalty (model.rs)


class UnigramTokenizer:
    """Viterbi unigram segmentation over an HF fast ``tokenizer.json``.

    Supported normalizers: NFC/NFD/NFKC/NFKD, Lowercase, Strip, Replace
    (string pattern), Sequence, Precompiled (approximated as NFKC — the
    charsmap is NFKC plus a handful of exotic mappings). Supported
    pre-tokenizers: Metaspace (split on the marker), WhitespaceSplit,
    Sequence. This covers XLM-R/e5/sentencepiece-converted checkpoints.
    """

    def __init__(self, tokenizer_json: str | Path) -> None:
        spec = json.loads(Path(tokenizer_json).read_text(encoding="utf-8"))
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(
                f"tokenizer.json model type {model.get('type')!r} is not "
                "Unigram (use WordPieceTokenizer for BERT-family vocabs)")
        self.vocab: dict[str, int] = {}
        self.scores: dict[str, float] = {}
        for i, (piece, score) in enumerate(model["vocab"]):
            self.vocab[piece] = i
            self.scores[piece] = float(score)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_id = int(model.get("unk_id", 0))
        min_score = min(self.scores.values()) if self.scores else 0.0
        self._unk_score = min_score - _UNK_PENALTY
        self._max_piece_len = max((len(p) for p in self.vocab), default=1)
        self._normalizers = self._flatten(spec.get("normalizer"))
        self._pre_tokenizers = self._flatten(spec.get("pre_tokenizer"))
        # added/special tokens are matched verbatim BEFORE normalization
        # (HF AddedVocabulary semantics): the input splits on them and
        # each plain segment runs the normal pipeline independently
        self._added = {t["content"]: int(t["id"])
                       for t in spec.get("added_tokens", [])}
        if self._added:
            import re
            self._added_re = re.compile("|".join(
                re.escape(c) for c in
                sorted(self._added, key=len, reverse=True)))
        else:
            self._added_re = None
        for content, tid in self._added.items():
            self.ids_to_tokens.setdefault(tid, content)
        # the Metaspace marker decode() must strip is the CONFIGURED
        # replacement, not the "▁" default
        self._metaspace_rep = next(
            (p.get("replacement", METASPACE) for p in self._pre_tokenizers
             if p.get("type") == "Metaspace"), METASPACE)
        # framing ids (XLM-R convention: <s> seq </s>); fall back to
        # whatever the vocab provides
        self.cls_id = self._lookup_first(["<s>", "[CLS]"])
        self.sep_id = self._lookup_first(["</s>", "[SEP]"])
        self.pad_id = self._lookup_first(["<pad>", "[PAD]"], default=0)

    def _lookup_first(self, names: list[str], default: int | None = None):
        for n in names:
            if n in self.vocab:
                return self.vocab[n]
            if n in self._added:
                return self._added[n]
        return default

    @staticmethod
    def _flatten(node) -> list[dict]:
        if node is None:
            return []
        key = ("normalizers" if "normalizers" in node else
               "pretokenizers" if "pretokenizers" in node else None)
        if node.get("type") == "Sequence" and key:
            out = []
            for sub in node[key]:
                out.extend(UnigramTokenizer._flatten(sub))
            return out
        return [node]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---------------------------------------------------------- normalize

    def normalize(self, text: str) -> str:
        for n in self._normalizers:
            t = n["type"]
            if t in ("NFC", "NFD", "NFKC", "NFKD"):
                text = unicodedata.normalize(t, text)
            elif t == "Precompiled":
                # the charsmap is NFKC + compatibility extras; NFKC is the
                # faithful approximation available without the blob decoder
                text = unicodedata.normalize("NFKC", text)
            elif t == "Lowercase":
                text = text.lower()
            elif t == "Strip":
                if n.get("strip_left", True):
                    text = text.lstrip()
                if n.get("strip_right", True):
                    text = text.rstrip()
            elif t == "Replace":
                pat = n.get("pattern", {})
                if "String" in pat:
                    text = text.replace(pat["String"], n.get("content", ""))
                else:
                    logger.warning("unsupported Replace pattern %r", pat)
            else:
                logger.warning("unsupported normalizer %r (skipped)", t)
        return text

    # ------------------------------------------------------- pre-tokenize

    def pre_tokenize(self, text: str) -> list[str]:
        pieces = [text]
        applied = False
        for p in self._pre_tokenizers:
            t = p["type"]
            if t == "WhitespaceSplit":
                pieces = [w for piece in pieces for w in piece.split()]
                applied = True
            elif t == "Metaspace":
                rep = p.get("replacement", METASPACE)
                scheme = p.get("prepend_scheme",
                               "always" if p.get("add_prefix_space", True)
                               else "never")
                out = []
                for pi, piece in enumerate(pieces):
                    if not piece:
                        continue
                    piece = piece.replace(" ", rep)
                    if scheme in ("always", "first") and (
                            pi == 0 or scheme == "always"):
                        if not piece.startswith(rep):
                            piece = rep + piece
                    if p.get("split", True):
                        out.extend(self._split_on_marker(piece, rep))
                    else:
                        out.append(piece)
                pieces = out
                applied = True
            else:
                logger.warning("unsupported pre_tokenizer %r (skipped)", t)
        if not applied:
            # bare sentencepiece behavior: one sequence, spaces -> marker,
            # leading marker prepended
            piece = METASPACE + text.replace(" ", METASPACE)
            pieces = [piece]
        return [p for p in pieces if p]

    @staticmethod
    def _split_on_marker(piece: str, rep: str) -> list[str]:
        """MergedWithNext split: each marker starts a new chunk."""
        out: list[str] = []
        current: list[str] = []
        for ch in piece:
            if ch == rep and current:
                out.append("".join(current))
                current = []
            current.append(ch)
        if current:
            out.append("".join(current))
        return out

    # ------------------------------------------------------------ viterbi

    def _viterbi(self, word: str) -> list[int]:
        """Maximum-score segmentation; unknown characters take
        min_score - 10 (HF semantics), consecutive unks fuse to one id."""
        n = len(word)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        maxl = self._max_piece_len
        for i in range(n):
            bi = best[i]
            if bi == NEG:
                continue
            hi = min(n, i + maxl)
            for j in range(i + 1, hi + 1):
                sub = word[i:j]
                sc = self.scores.get(sub)
                if sc is not None and bi + sc > best[j]:
                    best[j] = bi + sc
                    back[j] = (i, self.vocab[sub])
            if word[i:i + 1] not in self.vocab:
                if bi + self._unk_score > best[i + 1]:
                    best[i + 1] = bi + self._unk_score
                    back[i + 1] = (i, self.unk_id)
        if best[n] == NEG:  # unreachable (unk covers every char) — guard
            return [self.unk_id]
        ids_rev: list[int] = []
        pos = n
        while pos > 0:
            prev, tid = back[pos]  # type: ignore[misc]
            # fuse consecutive unknown tokens (fuse_unk)
            if not (tid == self.unk_id and ids_rev
                    and ids_rev[-1] == self.unk_id):
                ids_rev.append(tid)
            pos = prev
        return ids_rev[::-1]

    # ----------------------------------------------------------- encoding

    def tokenize_ids(self, text: str) -> list[int]:
        """Added-token split + normalize + pre-tokenize + per-word
        Viterbi; no framing. Added/special tokens embedded in the text
        emit their single id (HF parity)."""
        if self._added_re is None or not self._added_re.search(text):
            return self._tokenize_plain(text)
        out: list[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                out.extend(self._tokenize_plain(text[pos: m.start()]))
            out.append(self._added[m.group(0)])
            pos = m.end()
        if pos < len(text):
            out.extend(self._tokenize_plain(text[pos:]))
        return out

    def _tokenize_plain(self, text: str) -> list[int]:
        out: list[int] = []
        for word in self.pre_tokenize(self.normalize(text)):
            out.extend(self._viterbi(word))
        return out

    def tokenize(self, text: str) -> list[str]:
        return [self.ids_to_tokens.get(i, "<unk>")
                for i in self.tokenize_ids(text)]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """<s> ids... </s>, truncated to max_length keeping the trailing
        </s> (the HF truncation convention, same contract as
        WordPieceTokenizer.encode)."""
        ids = self.tokenize_ids(text)
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: list[str], seq_len: int):
        """Fixed-shape (N, seq_len) int32 ids + attention mask,
        right-padded — the shape contract the bucketed jitted forward
        expects."""
        import numpy as np
        ids = np.full((len(texts), seq_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), seq_len), np.int32)
        for i, text in enumerate(texts):
            row = self.encode(text, max_length=seq_len)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        skip = {self.cls_id, self.sep_id, self.pad_id} if skip_special \
            else set()
        toks = [self.ids_to_tokens.get(int(i), "")
                for i in ids if int(i) not in skip]
        return "".join(toks).replace(self._metaspace_rep, " ").strip()
