"""WordPiece tokenizer — BERT-compatible, vocab.txt-driven, no deps.

A copy of ``tpu_vector_db/pipeline/wordpiece.py`` (pure Python, no JAX):
basic tokenization (cleanup, lowercase + accent stripping,
punctuation/CJK splitting) followed by greedy longest-match-first
WordPiece with ``##`` continuation pieces, [CLS]/[SEP] framing,
truncation and padding. ``tests/test_torch_tokenizers.py`` holds it id
for id against the JAX package's tokenizer."""

from __future__ import annotations

import unicodedata
from pathlib import Path

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when Unicode doesn't
    # (e.g. "$", "`", "~")
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab.

    vocab: either a path to a vocab.txt (one token per line, line number =
    id — the HF convention) or an already-built token->id dict.
    """

    def __init__(self, vocab: str | Path | dict[str, int],
                 lowercase: bool = True, strip_accents: bool | None = None,
                 max_input_chars_per_word: int = 100,
                 pad_token: str = PAD, unk_token: str = UNK,
                 cls_token: str = CLS, sep_token: str = SEP) -> None:
        if isinstance(vocab, (str, Path)):
            self.vocab = self.load_vocab(vocab)
        else:
            self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        # HF semantics: strip_accents defaults to the lowercase flag
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.max_input_chars_per_word = max_input_chars_per_word
        # BERT vocabs use [PAD]/[UNK]/[CLS]/[SEP]; MPNet vocabs are
        # WordPiece too but frame with <s>/</s> and pad with <pad>
        # (transformers MPNetTokenizer defaults)
        self.unk_token = unk_token
        self._specials = (pad_token, cls_token, sep_token)
        for tok in (pad_token, unk_token, cls_token, sep_token):
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]

    @staticmethod
    def load_vocab(path: str | Path) -> dict[str, int]:
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return vocab

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------ basic tokenizer

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_word(self, word: str) -> list[str]:
        """Punctuation splitting after case/accent normalization."""
        if self.lowercase:
            word = word.lower()
        if self.strip_accents:
            word = "".join(c for c in unicodedata.normalize("NFD", word)
                           if unicodedata.category(c) != "Mn")
        pieces: list[str] = []
        current: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        # surround CJK ideographs with spaces (each becomes its own token)
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        tokens: list[str] = []
        for word in "".join(spaced).split():
            tokens.extend(self._split_word(word))
        return tokens

    # -------------------------------------------------------- wordpiece core

    def wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: list[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                # any unmatchable remainder voids the word
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for token in self.basic_tokenize(text):
            out.extend(self.wordpiece(token))
        return out

    # ------------------------------------------------------------ encoding

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """[CLS] pieces... [SEP], truncated to max_length (HF convention:
        truncation keeps the [SEP])."""
        ids = [self.vocab[t] for t in self.tokenize(text)]
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: list[str], seq_len: int):
        """Fixed-shape (N, seq_len) int32 ids + attention mask, right-padded
        — the shape contract the bucketed jitted forward expects."""
        import numpy as np
        ids = np.full((len(texts), seq_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), seq_len), np.int32)
        for i, text in enumerate(texts):
            row = self.encode(text, max_length=seq_len)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        toks = []
        specials = set(self._specials) | {MASK, "<mask>"}
        for i in ids:
            tok = self.ids_to_tokens.get(int(i), self.unk_token)
            if skip_special and tok in specials:
                continue
            toks.append(tok)
        text = " ".join(toks).replace(" ##", "")
        return text
