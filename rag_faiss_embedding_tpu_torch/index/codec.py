"""npz persistence codec for index tensors (bf16 <-> uint16 bit pattern).

Counterpart of ``rag_faiss_embedding_tpu/index/codec.py``, writing the same
format: numpy has no bfloat16, so bf16 tensors persist as their raw uint16
bit pattern, exactly. Reading also accepts the legacy void "|V2" saves, so
either package loads the other's files.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_host", "from_host"]


def to_host(arr: torch.Tensor) -> np.ndarray:
    """savez-able numpy copy of a tensor (bf16 -> uint16 bits, exact; every
    other dtype passes through)."""
    arr = arr.detach().cpu()
    if arr.dtype == torch.bfloat16:
        return arr.view(torch.int16).numpy().view(np.uint16)
    return arr.numpy()


def from_host(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_host`: reinterpret a stored array as ``dtype``.
    For bf16, takes the uint16 bit pattern or a legacy "|V2" array."""
    arr = np.asarray(arr)
    if dtype == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.as_tensor(arr, dtype=dtype)
