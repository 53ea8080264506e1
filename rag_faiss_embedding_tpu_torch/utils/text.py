"""Host-side text utilities: sentence splitting and bag-of-words similarity.

A copy of ``rag_faiss_embedding_tpu/utils/text.py``.

The reference uses spaCy for sentence segmentation and word-vector similarity
(``process_unstructured_html.py:87-142``). spaCy (and its model downloads)
are replaced with a dependency-free regex sentence splitter and TF cosine
similarity — the only uses are summarization heuristics, where bag-of-words
similarity serves the same dedup purpose (drop near-duplicate sentences).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List

_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g", "i.e",
    "fig", "al", "inc", "ltd", "co", "corp", "dept", "est", "approx", "no",
}

_SENT_BOUNDARY = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9\"'(])")


def sentence_split(text: str) -> List[str]:
    """Split text into sentences (regex, abbreviation-aware)."""
    text = text.strip()
    if not text:
        return []
    parts = _SENT_BOUNDARY.split(text)
    # Re-join splits caused by abbreviations like "Dr. Smith".
    merged: List[str] = []
    for part in parts:
        if merged:
            prev_last = merged[-1].rstrip(".").rsplit(" ", 1)[-1].lower()
            if prev_last in _ABBREV:
                merged[-1] = merged[-1] + " " + part
                continue
        merged.append(part)
    return [p.strip() for p in merged if p.strip()]


_WORD = re.compile(r"[a-z0-9]+")


def tf_vector(text: str) -> Dict[str, float]:
    """L2-normalized term-frequency vector."""
    counts = Counter(_WORD.findall(text.lower()))
    norm = math.sqrt(sum(c * c for c in counts.values()))
    if norm == 0:
        return {}
    return {w: c / norm for w, c in counts.items()}


def cosine_sim(a: Dict[str, float], b: Dict[str, float]) -> float:
    if len(b) < len(a):
        a, b = b, a
    return sum(v * b.get(w, 0.0) for w, v in a.items())
