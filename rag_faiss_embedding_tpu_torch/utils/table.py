"""Plain-text tables for the CLIs and the API client (the JAX package draws
them with ``rich``, which the card's machine does not have)."""

from __future__ import annotations

from typing import List

PREVIEW_CHARS = 200


def preview(text: str, limit: int = PREVIEW_CHARS) -> str:
    """``text`` cut to ``limit`` characters, on one line."""
    text = (text or "").replace("\n", " ")
    return text if len(text) <= limit else text[: limit - 1] + "…"


def format_table(title: str, header: List[str], rows: List[List[str]]) -> str:
    """A title line, the header, a rule, then the rows in left-aligned
    columns."""
    widths = [max(len(r[i]) for r in [header] + rows) for i in range(len(header))]
    line = lambda r: "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
    return "\n".join([title, line(header), line(["-" * w for w in widths])]
                     + [line(r) for r in rows])
