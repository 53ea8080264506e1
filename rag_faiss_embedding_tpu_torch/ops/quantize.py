"""Symmetric per-row int8 quantization (the FAISS SQ8 analog).

Counterpart of ``quantize_rows`` and ``dequantize`` in
``rag_faiss_embedding_tpu/ops/quantize.py``: each row stores
``round(x / scale)`` in int8 with ``scale = max|x| / 127`` (round half to
even in both frameworks, so the codes are bit-identical). The IVF-PQ refine
shadow keeps its rows this way. The int8 search tier itself (``int8_search``,
``int8_rerank_search``, int8 index storage) is not ported yet: it comes with
the int8 tier.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 per-row scales) of (N, D) rows."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """float32 rows back from int8 values and per-row scales."""
    return q.float() * scales[:, None]
