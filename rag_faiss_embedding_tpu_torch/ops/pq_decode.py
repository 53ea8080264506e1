"""PQ decode: the CUDA kernel and its plain version.

Port of ``rag_faiss_embedding_tpu/ops/pallas_pq.py`` (K4, ``_decode_kernel``).
``decode(codebooks, codes)`` turns (N, M) uint8 codes into (N, M * dsub)
rows in the codebook's dtype: row r's subspace s is codeword
``codebooks[s, codes[r, s]]``, bit for bit.

- On a CUDA tensor it launches ``csrc/pq_decode.cu`` (built on first use by
  ``_build``) or raises. The TPU kernel multiplies one-hot tiles by a
  block-diagonal grouped bf16 codebook, a workaround for the TPU's missing
  gathers; on the card the decode is a gather from shared memory, so
  ``grouped_codebook`` / ``pick_group`` and the JAX eligibility gate
  (``g * dsub == 128``, N % 128 == 0) have no counterpart: any N >= 0, any
  M, ksub <= 256. The codebook may be bfloat16 (``compute_dtype="bf16"``)
  or float32 (``"f32"``).
- On a CPU tensor it runs ``decode_reference``, the gather of
  ``ops/pq._decode_bf16`` (one flat index over the (M * ksub, dsub) table).

``decode.launches`` counts kernel launches (N = 0 launches nothing).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ESIZE = {torch.bfloat16: 2, torch.float32: 4}


def decode_reference(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: one flat gather of
    (N, M) rows from the (M * ksub, dsub) codebook table, in the codebook's
    dtype."""
    m, ksub, dsub = codebooks.shape
    idx = codes.long() + torch.arange(m, device=codes.device) * ksub
    return codebooks.reshape(m * ksub, dsub)[idx].reshape(codes.shape[0], m * dsub)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    points."""
    lib = _build.load("pq_decode")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rfe_pq_decode.argtypes = [vp] * 3 + [ci] * 5 + [vp]
    lib.rfe_pq_decode.restype = ci
    lib.rfe_pq_decode_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lib.rfe_pq_decode_plan.restype = ci
    lib.rfe_pq_decode_error_string.argtypes = [ci]
    lib.rfe_pq_decode_error_string.restype = ctypes.c_char_p
    return lib


def plan(m: int, ksub: int, dsub: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan for a codebook shape: subspace groups (grid
    y), subspaces per group, rows per tile, dynamic shared bytes, and
    whether the codebook is staged in shared memory."""
    lib = load()
    out = (ctypes.c_int * 5)()
    err = lib.rfe_pq_decode_plan(m, ksub, dsub, _ESIZE[dtype], out)
    if err:
        raise ValueError(f"pq_decode takes no codebook of shape ({m}, {ksub}, {dsub}): "
                         + lib.rfe_pq_decode_error_string(err).decode())
    return dict(zip(("groups", "per_group", "tile_rows", "smem_bytes", "staged"), out))


def decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Decode (N, M) uint8 codes against (M, ksub, dsub) bfloat16 or float32
    codebooks into (N, M * dsub) rows of the codebook's dtype."""
    if codebooks.ndim != 3 or codes.ndim != 2 or codes.shape[1] != codebooks.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} do not match codebooks "
                         f"{tuple(codebooks.shape)}")
    if codes.device.type != "cuda":
        return decode_reference(codebooks, codes)
    m, ksub, dsub = codebooks.shape
    if codebooks.dtype not in _ESIZE or codes.dtype != torch.uint8:
        raise TypeError(f"pq_decode takes uint8 codes and bfloat16 or float32 "
                        f"codebooks, got {codes.dtype} and {codebooks.dtype}")
    if not 1 <= ksub <= 256:
        raise ValueError(f"ksub must be in 1..256, got {ksub}")
    if codebooks.device != codes.device:
        raise ValueError("pq_decode operands must share one device")
    codes, codebooks = codes.contiguous(), codebooks.contiguous()
    n = codes.shape[0]
    out = torch.empty((n, m * dsub), dtype=codebooks.dtype, device=codes.device)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(codes.device):  # launch on the card that holds the codes
        err = lib.rfe_pq_decode(
            codes.data_ptr(), codebooks.data_ptr(), out.data_ptr(), n, m, ksub, dsub,
            _ESIZE[codebooks.dtype], torch.cuda.current_stream(codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError("pq_decode kernel launch failed: "
                           + lib.rfe_pq_decode_error_string(err).decode())
    decode.launches += 1
    return out


decode.launches = 0
