"""Inputs made from ``--seed``: vocabulary, text, documents and vectors.

Everything here is the benchmark's, handed alike to the program and to the
plain reference. Two rules keep runs of different seeds doing the same work:

- sizes (text lengths, arrival gaps, row counts) are drawn once from a fixed
  stream and only their order comes from the seed (``fixed_then_shuffled``);
- what the sizes hold (which words, which vectors) comes from the seed.

Vectors follow ``bench.py``'s distribution, frozen from ``chip_smoke.py``'s
``bench_rows`` (``chip_smoke.py:929``): rows are one of ``modes`` Gaussian
centres plus 0.7 noise, queries a row plus 0.3 noise.
"""

from __future__ import annotations

import string
from dataclasses import dataclass

import numpy as np
import torch

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
VOCAB_SIZE = 30522  # all-MiniLM-L6-v2's vocab_size
ROW_NOISE, QUERY_NOISE = 0.7, 0.3  # chip_smoke.py:933-939
COMPOUND_SHARE = 0.15  # words written as a vocabulary word plus a ## piece
FIXED = 0x5EED  # the stream that sizes are drawn from, for every seed


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number)."""
    h = np.random.SeedSequence([int(seed) & (2**64 - 1), *[int(t) for t in tags]])
    return int(h.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


def fixed_then_shuffled(seed: int, tag: int, draw) -> np.ndarray:
    """``draw(fixed_rng)``'s values, in an order drawn from ``seed``."""
    values = np.asarray(draw(np.random.default_rng([FIXED, tag])))
    return values[rng(seed, tag, 1).permutation(len(values))]


# ------------------------------------------------------------------ text
@dataclass
class Vocabulary:
    tokens: list  # id -> token, VOCAB_SIZE entries
    words: list  # whole words, in Zipf rank order
    suffixes: list  # "##" pieces


def vocabulary(seed: int) -> Vocabulary:
    """A WordPiece vocabulary of 30,522 entries: the 5 specials, 36 single
    characters and their ``##`` forms, then lowercase words (80%) and
    ``##`` suffixes, all drawn from the seed."""
    r = rng(seed, 1)
    chars = list(string.ascii_lowercase + string.digits)
    base = SPECIALS + chars + ["##" + c for c in chars]
    n_rest = VOCAB_SIZE - len(base)
    n_words = int(n_rest * 0.8)
    letters = np.array(list(string.ascii_lowercase))

    def draw(n, lo, hi, taken):
        out = []
        while len(out) < n:
            lens = r.integers(lo, hi + 1, size=2 * n)
            pool = letters[r.integers(0, 26, size=(2 * n, hi))]
            for row, ln in zip(pool, lens):
                w = "".join(row[:ln])
                if w not in taken:
                    taken.add(w)
                    out.append(w)
                    if len(out) == n:
                        break
        return out

    taken = set(base)
    words = draw(n_words, 2, 10, taken)
    suffixes = ["##" + s for s in draw(n_rest - n_words, 2, 4, set())]
    return Vocabulary(base + words + suffixes, words, suffixes)


@dataclass
class WordStream:
    """One long seeded text; a window of it is a document or a query."""
    text: str
    starts: np.ndarray  # char offset of each word, plus one past the end

    @property
    def n_words(self) -> int:
        return len(self.starts) - 1

    def __post_init__(self):
        self._at = self.starts.tolist()  # plain ints: fast to slice by

    def window(self, first: int, count: int) -> str:
        return self.text[self._at[first]:self._at[first + count] - 1]


def word_stream(vocab: Vocabulary, seed: int, n_words: int, tag: int = 2) -> WordStream:
    """``n_words`` words drawn by Zipf rank (exponent 1) over the vocabulary's
    words, ``COMPOUND_SHARE`` of them joined to a ``##`` suffix, so that
    WordPiece splits them."""
    r = rng(seed, tag)
    n = len(vocab.words)
    p = 1.0 / (np.arange(n) + 2.7)
    ranks = r.choice(n, size=n_words, p=p / p.sum())
    words = np.asarray(vocab.words, dtype=object)[ranks]
    comp = np.nonzero(r.random(n_words) < COMPOUND_SHARE)[0]
    sufs = np.asarray([s[2:] for s in vocab.suffixes], dtype=object)
    words[comp] = words[comp] + sufs[r.integers(0, len(sufs), size=len(comp))]
    lens = np.fromiter((len(w) + 1 for w in words), np.int64, n_words)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return WordStream(" ".join(words) + " ", starts)


def lognormal_lengths(n: int, median: float, sigma: float, lo: int, hi: int):
    """A function of a generator: ``n`` whole lengths, log-normal about
    ``median``, clipped to [lo, hi]."""
    return lambda g: np.clip(np.rint(g.lognormal(np.log(median), sigma, n)), lo, hi).astype(
        np.int64)


def windows(stream: WordStream, seed: int, tag: int, lengths: np.ndarray) -> np.ndarray:
    """A seeded start word for each length: (n, 2) of (start, length)."""
    starts = rng(seed, tag).integers(0, stream.n_words - lengths.max(), size=len(lengths))
    return np.stack([starts, lengths], 1)


@dataclass
class Corpus:
    """The stored documents: document ``i`` (id ``i + 1``) is a window of the
    stream. Its url and title follow from ``i``."""
    stream: WordStream
    spans: np.ndarray  # (n, 2) start word, length

    def content(self, i: int) -> str:
        s, n = self.spans[i]
        return self.stream.window(int(s), int(n))

    @staticmethod
    def url(i: int) -> str:
        return f"https://corpus.example/doc/{i}"

    @staticmethod
    def title(i: int) -> str:
        return f"document {i}"

    def document(self, i: int) -> dict:
        return {"url": self.url(i), "title": self.title(i), "content": self.content(i)}

    def documents(self):
        """Every document, in id order (fast: plain ints)."""
        text, at = self.stream.text, self.stream._at
        for i, (s, n) in enumerate(self.spans.tolist()):
            yield {"url": self.url(i), "title": self.title(i), "content": text[at[s]:at[s + n] - 1]}


def corpus(vocab: Vocabulary, seed: int, n_docs: int, words: tuple) -> Corpus:
    """``n_docs`` documents of ``words`` = (lo, hi) words, uniform, over a
    stream of 2M words."""
    lo, hi = words
    stream = word_stream(vocab, seed, 1 << 21)
    lengths = fixed_then_shuffled(seed, 3, lambda g: g.integers(lo, hi + 1, size=n_docs))
    return Corpus(stream, windows(stream, seed, 4, lengths))


# --------------------------------------------------------------- vectors
def centres(seed: int, modes: int, dim: int, device):
    g = torch.Generator(device=device).manual_seed(subseed(seed, 10))
    return torch.randn(modes, dim, generator=g, device=device)


def shard_rows(seed: int, shard: int, n: int, centre, device):
    """Rows of shard ``shard`` (bench.py's distribution), made on ``device``:
    the same seed and shard give the same rows."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, 11, shard))
    c = centre.to(device)
    rows = c[torch.randint(0, len(c), (n,), generator=g, device=device)]
    rows += ROW_NOISE * torch.randn(n, c.shape[1], generator=g, device=device)
    return rows


def query_rows(seed: int, rows_of, n_rows: int, n: int, device, tag: int = 12):
    """``n`` queries, each a row plus 0.3 noise. ``rows_of(ids)`` gives the
    rows of global ids (any device)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, tag))
    ids = torch.randint(0, n_rows, (n,), generator=g, device=device)
    q = rows_of(ids).to(device)
    return q + QUERY_NOISE * torch.randn(q.shape, generator=g, device=device)


# --------------------------------------------------------------- weights
def minilm_shapes(cfg: dict) -> dict:
    """Name -> shape of every MiniLM weight, in ``torch.nn.Linear``'s
    (out, in) layout, with the kind that sets its distribution."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    shapes = {
        "word": ((cfg["vocab_size"], h), "matrix"),
        "position": ((cfg["max_position_embeddings"], h), "matrix"),
        "token_type": ((cfg["type_vocab_size"], h), "matrix"),
        "emb_ln.w": ((h,), "scale"), "emb_ln.b": ((h,), "bias"),
    }
    for i in range(cfg["num_hidden_layers"]):
        for name, out, inp in (("q", h, h), ("k", h, h), ("v", h, h), ("o", h, h),
                               ("ff1", f, h), ("ff2", h, f)):
            shapes[f"{i}.{name}.w"] = ((out, inp), "matrix")
            shapes[f"{i}.{name}.b"] = ((out,), "bias")
        for ln in ("ln1", "ln2"):
            shapes[f"{i}.{ln}.w"] = ((h,), "scale")
            shapes[f"{i}.{ln}.b"] = ((h,), "bias")
    return shapes


def minilm_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight, float32 on ``device``, from one seeded draw: matrices
    normal with std 1/sqrt(fan in) (the program's own random init), biases
    and LayerNorm shifts std 0.02, LayerNorm scales 1 + 0.02 normal."""
    shapes = minilm_shapes(cfg)
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    g = torch.Generator(device=device).manual_seed(subseed(seed, 20))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind) in shapes.items():
        n = int(np.prod(shape))
        w = flat[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            w = w * shape[1] ** -0.5
        elif kind == "scale":
            w = 1.0 + 0.02 * w
        else:
            w = 0.02 * w
        out[name] = w
    return out
