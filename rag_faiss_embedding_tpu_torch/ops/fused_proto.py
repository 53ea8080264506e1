"""Fused union-block top-k (the IVF prototype's kernel): CUDA and plain.

Port of ``benchmarks/pallas_fused_proto.py`` (K5, ``kern`` via
``fused_pallas_chunks``). ``block_topk`` keeps the JAX function's contract
and output layout:

- per chunk of ``qc`` bf16 queries and per cell of ``bb`` consecutive union
  blocks ``u_all[c, b*bb:(b+1)*bb]``, every row of the cell is scored in
  float32: ``2 q.x - ||x||^2``, NEG_INF where the row id is < 0;
- per query, ``kp`` passes of max-then-lowest-id (``_extract_topk`` of
  ``ops/pallas_scan.py``): the ``kp`` best distinct ids of the cell. An id
  is taken once per cell, so a row that spill put into two lists of one
  cell comes back once; across cells it may come back twice;
- slots past a cell's live rows hold NEG_INF and id -1 (the TPU kernel's
  ids there are arbitrary, so only slots above NEG_INF are compared with
  it).

Output: (chunks, ucap / bb, qc, kp) float32 scores and int32 ids.

- On CUDA tensors it launches ``csrc/fused_proto.cu`` or raises. The kernel
  is chosen by shape before the launch: the tensor-core block (bf16
  ``mma.sync``, f32 accumulation) where D is a multiple of 16 and its
  shared memory fits (D <= 400 on an H100), the FMA block elsewhere.
- On CPU tensors it runs ``block_topk_reference``, the same contract in
  plain torch.

The plain version sums each score's exact bf16 products in column order
(``ordered_dot``): the FMA block's order, so the two agree bit for bit. The
tensor cores sum in another order, so the tensor-core block agrees with the
plain version to float32 rounding, and its ids may differ from the plain
version's only where two scores are that close.

``block_topk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from .distance import NEG_INF

__all__ = ["block_topk", "block_topk_reference", "ordered_dot", "KP_MAX"]

KP_MAX = 32  # the kernel's list length (csrc/fused_proto.cu KPMAX)
_INT_MAX = torch.iinfo(torch.int32).max


def _check_args(qs, u_all, codes3, sq2, ids2, bb, kp):
    if qs.ndim != 3 or codes3.ndim != 3 or u_all.ndim != 2:
        raise ValueError("qs, codes3 must be 3-d and u_all 2-d")
    chunks, _, d = qs.shape
    nblocks, window, dc = codes3.shape
    if dc != d:
        raise ValueError(f"codes3 {tuple(codes3.shape)} does not match queries of dim {d}")
    if sq2.shape != (nblocks, window) or ids2.shape != (nblocks, window):
        raise ValueError("sq2 / ids2 must be (nlist + 1, window)")
    if u_all.shape[0] != chunks:
        raise ValueError("u_all needs one row per chunk")
    if bb < 1 or u_all.shape[1] % bb:
        raise ValueError(f"ucap={u_all.shape[1]} must be a multiple of bb={bb}")
    if not 1 <= kp <= KP_MAX:
        raise ValueError(f"kp must be in 1..{KP_MAX}, got {kp}")


def ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` over broadcast float32 operands, summed in index
    order from +0 into one accumulator per output: the FMA kernels' order. A
    product of two bf16 values is exact in float32, so on bf16 inputs this
    gives the FMA kernels' bits."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        acc += a[..., c] * b[..., c]
    return acc


def extract_topk(scores: torch.Tensor, gidx: torch.Tensor,
                 kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kp`` passes of max, then the lowest id at the max, then every entry
    of that id masked (``pallas_scan._extract_topk``) over the last axis;
    slots at NEG_INF get id -1."""
    vals, idxs = [], []
    s = scores
    for _ in range(kp):
        m = s.max(dim=-1, keepdim=True).values
        sel = torch.where(s == m, gidx, _INT_MAX).min(dim=-1).values
        vals.append(m[..., 0])
        idxs.append(sel)
        s = torch.where(gidx == sel[..., None], NEG_INF, s)
    v, i = torch.stack(vals, -1), torch.stack(idxs, -1)
    return v, torch.where(v > NEG_INF, i, -1).to(torch.int32)


def block_topk_reference(qs, u_all, codes3, sq2, ids2, *, bb: int,
                         kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel, on any device: each chunk's cells
    scored in column order (``ordered_dot``), then ``extract_topk``."""
    _check_args(qs, u_all, codes3, sq2, ids2, bb, kp)
    chunks, qc, d = qs.shape
    window = codes3.shape[1]
    nb = u_all.shape[1] // bb
    out_v, out_i = [], []
    for c in range(chunks):
        blocks = u_all[c].long().view(nb, bb)
        rows = codes3[blocks].float().view(nb, bb * window, d)
        rsq = sq2[blocks].float().view(nb, 1, bb * window)
        rid = ids2[blocks].view(nb, 1, bb * window)
        s = 2.0 * ordered_dot(qs[c].float()[None, :, None], rows[:, None]) - rsq
        s = torch.where(rid >= 0, s, NEG_INF)
        v, i = extract_topk(s, rid.expand_as(s), kp)
        out_v.append(v)
        out_i.append(i)
    return torch.stack(out_v), torch.stack(out_i)


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    points."""
    lib = _build.load("fused_proto")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rfe_fused_proto.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    lib.rfe_fused_proto.restype = ci
    lib.rfe_fused_proto_kp_max.argtypes = []
    lib.rfe_fused_proto_kp_max.restype = ci
    lib.rfe_fused_proto_tile_rows.argtypes = []
    lib.rfe_fused_proto_tile_rows.restype = ci
    lib.rfe_fused_proto_tc_fits.argtypes = [ci]
    lib.rfe_fused_proto_tc_fits.restype = ci
    lib.rfe_fused_proto_error_string.argtypes = [ci]
    lib.rfe_fused_proto_error_string.restype = ctypes.c_char_p
    if lib.rfe_fused_proto_kp_max() != KP_MAX:
        raise RuntimeError(f"fused_proto.cu has KPMAX={lib.rfe_fused_proto_kp_max()}, "
                           f"ops/fused_proto.py has {KP_MAX}")
    return lib


@functools.lru_cache(maxsize=None)
def uses_tensor_cores(device_index: int, d: int) -> bool:
    """Whether ``block_topk`` runs the tensor-core block for width ``d`` on
    the card (else the FMA block): D a multiple of 16 whose block fits in
    the card's shared memory. The kernel's entry point makes the same
    choice by shape before its launch; this asks it, for reporting."""
    lib = load()
    with torch.cuda.device(device_index):
        fits = lib.rfe_fused_proto_tc_fits(d)
    if fits < 0:
        raise RuntimeError("fused_proto: " + lib.rfe_fused_proto_error_string(-fits).decode())
    return bool(fits)


def block_topk(qs, u_all, codes3, sq2, ids2, *, bb: int,
               kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``kp`` distinct ids of each (chunk, cell of ``bb`` union blocks)
    per query: (chunks, ucap / bb, qc, kp) float32 scores and int32 ids.

    ``qs`` (chunks, qc, D) bf16; ``u_all`` (chunks, ucap) int32 block ids;
    ``codes3`` (nlist+1, window, D) bf16; ``sq2`` (nlist+1, window) f32;
    ``ids2`` (nlist+1, window) int32."""
    _check_args(qs, u_all, codes3, sq2, ids2, bb, kp)
    if codes3.device.type != "cuda":
        return block_topk_reference(qs, u_all, codes3, sq2, ids2, bb=bb, kp=kp)
    if qs.dtype != torch.bfloat16 or codes3.dtype != torch.bfloat16:
        raise TypeError(f"block_topk takes bfloat16 queries and rows, got "
                        f"{qs.dtype} and {codes3.dtype}")
    if u_all.dtype != torch.int32 or ids2.dtype != torch.int32 or sq2.dtype != torch.float32:
        raise TypeError("u_all and ids2 must be int32, sq2 float32")
    for t in (qs, u_all, sq2, ids2):
        if t.device != codes3.device:
            raise ValueError("block_topk operands must share one device")
    lib = load()
    chunks, qc, d = qs.shape
    window = codes3.shape[1]
    ucap = u_all.shape[1]
    if d % 8 or window % lib.rfe_fused_proto_tile_rows():
        raise ValueError(f"the kernel needs D % 8 == 0 and window % "
                         f"{lib.rfe_fused_proto_tile_rows()} == 0, got {d}, {window}")
    qs, u_all, codes3 = qs.contiguous(), u_all.contiguous(), codes3.contiguous()
    sq2, ids2 = sq2.contiguous(), ids2.contiguous()
    shape = (chunks, ucap // bb, qc, kp)
    out_v = torch.empty(shape, dtype=torch.float32, device=qs.device)
    out_i = torch.empty(shape, dtype=torch.int32, device=qs.device)
    err = lib.rfe_fused_proto(
        qs.data_ptr(), u_all.data_ptr(), codes3.data_ptr(), sq2.data_ptr(), ids2.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), chunks, qc, d, ucap, window, bb, kp,
        torch.cuda.current_stream(qs.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_proto kernel launch failed: "
                           + lib.rfe_fused_proto_error_string(err).decode())
    block_topk.launches += 1
    return out_v, out_i


block_topk.launches = 0
