"""Plain BERT WordPiece tokenization (the reference's, written fresh).

BERT's basic tokenizer (drop control characters, split on whitespace and
punctuation, lowercase, strip accents), then greedy longest-match WordPiece
with ``##`` continuations, a word longer than 100 characters or with no
match becoming ``[UNK]``; ``[CLS] ... [SEP]``, cut to ``max_length``.
"""

from __future__ import annotations

import unicodedata


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _cjk(cp: int) -> bool:
    return any(a <= cp <= b for a, b in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def basic_words(text: str) -> list:
    words, cur = [], ""
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD) or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        if ch.isspace() or _cjk(cp) or _punct(ch):
            if cur:
                words.append(cur)
            cur = ""
            if not ch.isspace():
                words.append(ch)
            continue
        cur += ch
    if cur:
        words.append(cur)
    out = []
    for w in words:
        w = unicodedata.normalize("NFD", w.lower())
        w = "".join(c for c in w if unicodedata.category(c) != "Mn")
        if w:
            out.append(w)
    return out


class WordPiece:
    def __init__(self, tokens: list):
        self.ids = {t: i for i, t in enumerate(tokens)}
        self.unk, self.cls, self.sep = (self.ids[t] for t in ("[UNK]", "[CLS]", "[SEP]"))

    def word(self, w: str) -> list:
        if len(w) > 100:
            return [self.unk]
        out, start = [], 0
        while start < len(w):
            for end in range(len(w), start, -1):
                piece = w[start:end] if start == 0 else "##" + w[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return out

    def encode(self, text: str, max_length: int = 512) -> list:
        ids = [self.cls]
        for w in basic_words(text):
            ids += self.word(w)
            if len(ids) >= max_length - 1:
                break
        return ids[:max_length - 1] + [self.sep]
