"""Host-side WordPiece tokenizer.

A copy of ``rag_faiss_embedding_tpu/models/tokenizer.py`` that imports no
JAX (importing that module runs ``models/__init__``, which loads the Flax
encoder). Same vocab files, same ids; the C++ fast path is this package's
copy of the JAX package's ``native`` module.

The reference leans on HF ``AutoTokenizer`` (``vectorization.py:13,29-35``:
pad-to-longest, truncate at 512). This is a from-scratch BERT-style WordPiece
implementation so the framework is self-contained and offline-capable:

- BERT basic tokenization: control-char cleanup, lowercasing + accent
  stripping (NFD), CJK char isolation, punctuation splitting;
- greedy longest-match WordPiece with ``##`` continuations;
- ``[CLS] ... [SEP]`` assembly, truncation, and **bucketed padding**: batches
  pad to the next power-of-two length (16..max_len) instead of pad-to-longest
  — a TPU-specific choice so XLA compiles a handful of shapes once instead of
  recompiling per batch (the reference's pad-to-longest is fine for eager
  torch, hostile to jit).

Vocab sources: a real ``vocab.txt`` (HF cache or file, giving exact parity
with the reference tokenizer), or a corpus-trained vocab — via the HF
``tokenizers`` WordPiece trainer when available, else a built-in
frequency-based trainer (chars + frequent words + frequent suffix pieces).

A C++ fast path (native/tokenizer.cpp, loaded via ctypes) accelerates
``encode`` for serving; this module is the reference implementation and
fallback.
"""

from __future__ import annotations

import unicodedata
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.logging import get_logger

logger = get_logger(__name__)

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_BUCKETS = (16, 32, 64, 128, 256, 512)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0xF900 <= cp <= 0xFAFF
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT-style pre-tokenization."""
    out: List[str] = []
    buf: List[str] = []

    def flush():
        if buf:
            out.append("".join(buf))
            buf.clear()

    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        if ch.isspace():
            flush()
            continue
        if _is_cjk(cp) or _is_punct(ch):
            flush()
            out.append(ch)
            continue
        buf.append(ch)
    flush()
    if lowercase:
        norm = []
        for tok in out:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            if tok:
                norm.append(tok)
        return norm
    return out


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        max_word_chars: int = 100,
    ):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars
        for sp in (PAD, UNK, CLS, SEP):
            if sp not in vocab:
                raise ValueError(f"vocab missing special token {sp}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self._native = None  # lazily-attached C++ fast path

    # ------------------------------------------------------------ encoding
    def wordpiece(self, word: str) -> List[int]:
        """Greedy longest-match segmentation of one word."""
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                pid = self.vocab.get(piece)
                if pid is not None:
                    cur = pid
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def enable_native(self) -> bool:
        """Attach the C++ fast path (native/tokenizer.cpp). Safe no-op when
        the toolchain is unavailable; non-ASCII texts transparently fall back
        to this Python implementation, so results are identical either way."""
        if self._native is not None:
            return True
        try:
            from ..native import NativeWordPiece

            self._native = NativeWordPiece(self.vocab, lowercase=self.lowercase)
            return True
        except Exception as e:  # pragma: no cover - toolchain-dependent
            logger.debug("native tokenizer unavailable: %s", e)
            return False

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        """Token ids with [CLS]/[SEP], truncated to max_length."""
        if self._native is not None:
            ids = self._native.encode(text, max_length)
            if ids is not None:
                return ids
        ids = [self.cls_id]
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self.wordpiece(word))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        return ids

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int = 512,
        bucketed: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask) int32 arrays, padded.

        ``bucketed=True`` pads to the next power-of-two bucket <= max_length
        so jit sees a small fixed set of shapes.
        """
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        if bucketed:
            pad_to = next((b for b in _BUCKETS if b >= longest and b <= max_length),
                          max_length)
            pad_to = min(max(pad_to, longest), max_length)
        else:
            pad_to = longest
        ids = np.full((len(encoded), pad_to), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), pad_to), np.int32)
        for r, e in enumerate(encoded):
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        return ids, mask

    def decode(self, ids: Iterable[int]) -> str:
        toks = []
        special = {self.pad_id, self.cls_id, self.sep_id}
        for i in ids:
            if int(i) in special:
                continue
            toks.append(self.inv_vocab.get(int(i), UNK))
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---------------------------------------------------------------- io
    def save(self, path: str | Path) -> None:
        """Write vocab.txt (one token per line, line number = id)."""
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(t for t, _ in items) + "\n")

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        vocab = {}
        for i, line in enumerate(Path(path).read_text().splitlines()):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def from_hf_cache(cls, model_name: str, **kw) -> Optional["WordPieceTokenizer"]:
        """Load the real model vocab from a local HF cache, if present."""
        try:
            from transformers.utils import cached_file

            path = cached_file(
                model_name, "vocab.txt", local_files_only=True,
                _raise_exceptions_for_missing_entries=False,
            )
        except Exception:
            path = None
        if not path:
            return None
        logger.info("loaded tokenizer vocab from HF cache for %s", model_name)
        return cls.from_vocab_file(path, **kw)

    # ------------------------------------------------------------ training
    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        vocab_size: int = 30522,
        min_frequency: int = 2,
        **kw,
    ) -> "WordPieceTokenizer":
        """Train a WordPiece vocab on a corpus (offline bootstrap path)."""
        texts = list(texts)
        try:
            return cls._train_hf(texts, vocab_size, min_frequency, **kw)
        except Exception as e:
            logger.debug("hf tokenizers trainer unavailable (%s)", e)
        return cls._train_builtin(texts, vocab_size, min_frequency, **kw)

    @classmethod
    def _train_hf(cls, texts, vocab_size, min_frequency, **kw):
        from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

        tok = Tokenizer(models.WordPiece(unk_token=UNK))
        tok.normalizer = normalizers.Sequence(
            [normalizers.NFD(), normalizers.Lowercase(), normalizers.StripAccents()]
        )
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        trainer = trainers.WordPieceTrainer(
            vocab_size=vocab_size,
            min_frequency=min_frequency,
            special_tokens=SPECIALS,
            continuing_subword_prefix="##",
        )
        tok.train_from_iterator(texts, trainer)
        vocab = tok.get_vocab()
        # Reindex specials to the front for stable ids.
        ordered = SPECIALS + sorted(t for t in vocab if t not in SPECIALS)
        return cls({t: i for i, t in enumerate(ordered)}, **kw)

    @classmethod
    def _train_builtin(cls, texts, vocab_size, min_frequency, **kw):
        """Dependency-free trainer: chars, frequent words, frequent suffixes."""
        words = Counter()
        for t in texts:
            words.update(basic_tokenize(t))
        chars = Counter()
        suffixes = Counter()
        for w, c in words.items():
            for ch in w:
                chars[ch] += c
            for i in range(1, len(w)):
                if len(w) - i <= 8:
                    suffixes["##" + w[i:]] += c
        vocab_list = list(SPECIALS)
        vocab_list += [ch for ch, c in chars.most_common() if c >= 1]
        vocab_list += ["##" + ch for ch, c in chars.most_common() if c >= 1]
        budget = vocab_size - len(vocab_list)
        words_sorted = [w for w, c in words.most_common() if c >= min_frequency]
        take_words = words_sorted[: int(budget * 0.7)]
        vocab_list += take_words
        budget = vocab_size - len(vocab_list)
        vocab_list += [
            s for s, c in suffixes.most_common(budget) if c >= min_frequency
        ]
        seen, final = set(), []
        for t in vocab_list:
            if t not in seen:
                seen.add(t)
                final.append(t)
        return cls({t: i for i, t in enumerate(final[:vocab_size])}, **kw)
