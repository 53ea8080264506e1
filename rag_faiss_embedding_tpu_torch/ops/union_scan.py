"""Fused IVF union scan: the CUDA kernel and its plain version.

Port of ``rag_faiss_embedding_tpu/ops/pallas_ivf.py``: K2 (``_make_kernel``,
``variant=1``) and K3 (``_make_kernel_v2``, ``variant=2`` with the optional
in-kernel final top-``ktop``) become one CUDA source, ``csrc/union_scan.cu``.
``union_scan`` keeps the JAX function's contract and output layout:

- per chunk of ``qc`` queries, every list block named by ``u_all`` (the
  chunk's union; the sentinel id ``nlist`` is an all-dead block) is scored
  against the chunk's queries in float32: ``2 q.x - ||x||^2`` (L2) or
  ``q.x`` (IP);
- a score is packed into an int32 that orders like the float
  (``mono_i32``), with its low ``ceil(log2(U))`` bits replaced by the
  block's position in the union;
- each (query, slot-in-window) bin keeps its top ``cap`` packed values over
  all U blocks, and the result is (chunks, qc, cap * window) int32, level
  major; with ``ktop`` (variant 2) the kernel also takes the top ``ktop``
  of those candidates per query (ties to the lowest lane) and returns
  (packed, lane) pairs padded to 128 lanes.

Variant 1 masks dead rows (id < 0) to ``NEG_INF``; variant 2 folds them into
the norm operand (``DEAD_SQ``) and takes queries pre-doubled for L2 (exact).

- On CUDA tensors it launches the kernel or raises. Stage 1 runs on bf16
  tensor cores for bf16 storage (``mma.sync``, float32 accumulation: the
  products are exact, only the sum order differs), on FP32 FMA for float32
  storage.
- On CPU tensors it runs ``union_scan_reference``, the same contract in
  plain torch.

Decoding (``decode_topk``, ``decode_selected``) is plain torch on either
device, as it is XLA code outside the kernel in the JAX package. In the
port's IVF index, ``backend="pallas"`` means this function: the kernel on a
CUDA index, its plain version on a CPU one.

``union_scan.launches`` counts kernel launches, and
``union_scan.variant_launches`` splits them by variant (K2, K3).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .distance import NEG_INF, small_topk

__all__ = [
    "union_scan", "union_scan_reference", "decode_topk", "decode_selected",
    "kernel_eligible", "pick_bb", "mono_i32", "unmonotone_f32",
]

KPAD = 128          # lanes of the in-kernel top-k output (JAX's kpad)
MAX_CAP = 4         # bin depth the kernel is built for
DEAD_SQ = 1e30      # variant 2's norm for dead rows (JAX's _DEAD_SQ)
# the JAX kernel's target bytes of union blocks per grid cell. A CUDA block
# has no use for it, but the union is padded to a multiple of pick_bb(...)
# before the scan, and that padding sets the packing width
_CELL_BLOCK_BYTES = 2 << 20
_WAVES = 4         # stage-1 blocks to aim for, in waves of what the card holds


def mono_i32_host(x: float) -> int:
    """Host-side order-preserving f32 -> int32 map."""
    bits = int(np.array(np.float32(x)).view(np.int32))
    return bits ^ 0x7FFFFFFF if bits < 0 else bits


def mono_i32(s: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 map: negatives flip their magnitude
    bits, positives pass through, so int32 order is float order (-0.0 sorts
    just below +0.0)."""
    bits = s.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def unmonotone_f32(mono: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mono_i32`."""
    bits = torch.where(mono < 0, mono ^ 0x7FFFFFFF, mono)
    return bits.contiguous().view(torch.float32)


def packing_bits(u: int) -> int:
    """Low bits that carry the union position: ceil(log2(U)), at least 1."""
    return max(1, int(math.ceil(math.log2(max(u, 2)))))


@functools.lru_cache(maxsize=None)
def init_packed(nbits: int) -> int:
    """The empty-bin value: NEG_INF packed with union position 0."""
    return mono_i32_host(NEG_INF) & ~((1 << nbits) - 1)


def pick_bb(window: int, dim: int, itemsize: int, u_pad: int) -> int:
    """The JAX kernel's union blocks per grid cell; the union is padded to a
    multiple of it before the scan (same rule, same padding)."""
    block_bytes = window * dim * itemsize
    bb = max(1, min(16, _CELL_BLOCK_BYTES // max(block_bytes, 1)))
    return min(bb, u_pad)


def kernel_eligible(*, platform: str, quantized: bool, window: int, dim: int,
                    qc: int, shadow, interpret: bool = False) -> bool:
    """Dispatch guard for the union-scan route (twin of ``pallas_eligible``):
    full-precision storage, no shadow, window and dim multiples of 128, at
    least 16 queries per chunk, and a CUDA index (or ``interpret``: the
    route asked for explicitly, which runs the plain version on a CPU
    index)."""
    return (
        (platform == "cuda" or interpret)
        and not quantized
        and shadow is None
        and window % 128 == 0
        and dim % 128 == 0
        and qc >= 16
    )


def _check_args(qs, u_all, codes3, sorted_sq, sorted_ids, window, cap,
                metric, variant, ktop):
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    if ktop and variant != 2:
        raise ValueError("in-kernel top-k is a variant-2 feature")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"cap must be in 1..{MAX_CAP}, got {cap}")
    if ktop and not 0 < ktop <= min(KPAD, cap * window - 1):
        raise ValueError(f"ktop={ktop} must be below cap*window and <= {KPAD}")
    chunks, qc, d = qs.shape
    if codes3.shape[1:] != (window, d):
        raise ValueError(f"codes3 {tuple(codes3.shape)} is not (nlist+1, {window}, {d})")
    n_slots = codes3.shape[0] * window
    if sorted_sq.shape != (n_slots,) or sorted_ids.shape != (n_slots,):
        raise ValueError("sorted_sq / sorted_ids must hold one entry per slot")
    if u_all.shape[0] != chunks:
        raise ValueError("u_all needs one row per chunk")


def _variant_queries(qs, metric, variant):
    """Variant 2 takes L2 queries pre-doubled (exact in any binary float)."""
    if variant == 2 and metric == "L2":
        return (qs.float() * 2.0).to(qs.dtype)
    return qs


def _premasked_sq(sorted_sq, sorted_ids, metric):
    """Variant 2's norm operand: the L2 norms (zeros for IP), DEAD_SQ at
    dead rows, so a dead row's score loses to every live one."""
    rsq = sorted_sq.float() if metric == "L2" else torch.zeros_like(sorted_sq, dtype=torch.float32)
    return torch.where(sorted_ids >= 0, rsq, torch.full_like(rsq, DEAD_SQ))


def _select_ktop(cand: torch.Tensor, ktop: int, nbits: int):
    """Top ``ktop`` of (rows, M) packed candidates, ties to the lowest lane,
    padded to KPAD lanes with the empty value / lane 0."""
    rows = cand.shape[0]
    vals, lanes = small_topk(cand, ktop)
    pad_v = torch.full((rows, KPAD - ktop), init_packed(nbits),
                       dtype=torch.int32, device=cand.device)
    pad_l = torch.zeros((rows, KPAD - ktop), dtype=torch.int32, device=cand.device)
    return torch.cat([vals, pad_v], 1), torch.cat([lanes, pad_l], 1)


def union_scan_reference(qs, u_all, codes3, sorted_sq, sorted_ids, *,
                         window: int, cap: int, metric: str, variant: int = 1,
                         ktop: int = 0):
    """Plain torch version of the kernel, on any device: the chunk's scores
    by one float32 product, packed, then the top ``cap`` per bin by a stable
    descending sort over the U axis (the packed values of one bin are
    distinct, so any exact selection gives the same set)."""
    _check_args(qs, u_all, codes3, sorted_sq, sorted_ids, window, cap,
                metric, variant, ktop)
    chunks, qc, d = qs.shape
    u = u_all.shape[1]
    nbits = packing_bits(u)
    mask_hi = ~((1 << nbits) - 1)
    qv = _variant_queries(qs, metric, variant)
    rsq = _premasked_sq(sorted_sq, sorted_ids, metric) if variant == 2 else sorted_sq.float()
    rsq2, ids2 = rsq.view(-1, window), sorted_ids.view(-1, window)
    jglob = torch.arange(u, dtype=torch.int32, device=qs.device)[None, :, None]
    outs, lanes = [], []
    for c in range(chunks):
        blocks = u_all[c].long()
        rows = codes3[blocks].float()                       # (U, window, D)
        dots = torch.einsum("qd,uwd->quw", qv[c].float(), rows)
        if variant == 2:
            s = dots - rsq2[blocks][None]
        else:
            s = 2.0 * dots - rsq2[blocks][None] if metric == "L2" else dots
            s = torch.where(ids2[blocks][None] >= 0, s, torch.full_like(s, NEG_INF))
        packed = (mono_i32(s) & mask_hi) | jglob            # (qc, U, window)
        top = torch.sort(packed, dim=1, descending=True, stable=True).values[:, :cap]
        if top.shape[1] < cap:  # fewer union blocks than levels
            fill = torch.full((qc, cap - top.shape[1], window), init_packed(nbits),
                              dtype=torch.int32, device=qs.device)
            top = torch.cat([top, fill], 1)
        cand = top.reshape(qc, cap * window)
        if ktop:
            v, lane = _select_ktop(cand, ktop, nbits)
            outs.append(v)
            lanes.append(lane)
        else:
            outs.append(cand)
    if ktop:
        return torch.stack(outs), torch.stack(lanes)
    return torch.stack(outs)


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    points."""
    lib = _build.load("union_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rfe_union_scan.argtypes = [vp] * 8 + [ci] * 16 + [vp]
    lib.rfe_union_scan.restype = ci
    lib.rfe_union_scan_blocks_per_sm.argtypes = [ci] * 5
    lib.rfe_union_scan_blocks_per_sm.restype = ci
    lib.rfe_union_scan_max_cap.argtypes = []
    lib.rfe_union_scan_max_cap.restype = ci
    lib.rfe_union_scan_tile_rows.argtypes = []
    lib.rfe_union_scan_tile_rows.restype = ci
    lib.rfe_union_scan_block_queries.argtypes = [ci]
    lib.rfe_union_scan_block_queries.restype = ci
    lib.rfe_union_scan_error_string.argtypes = [ci]
    lib.rfe_union_scan_error_string.restype = ctypes.c_char_p
    if lib.rfe_union_scan_max_cap() != MAX_CAP:
        raise RuntimeError(
            f"union_scan.cu has MAX_CAP={lib.rfe_union_scan_max_cap()}, "
            f"ops/union_scan.py has {MAX_CAP}")
    return lib


@functools.lru_cache(maxsize=None)
def _stage1(device_index: int, d: int, is_bf16: bool, cap: int,
            mode: int) -> Tuple[bool, int, int, int]:
    """(tensor cores, queries per block, slots per block, blocks the card
    holds at once) of the stage-1 kernel for a shape (mode 0 / 1 / 2 / 3:
    variant 1 L2 / 1 IP / 2 L2 / 2 IP). bf16 storage runs on tensor cores
    wherever that kernel's shared memory fits (D <= 440), the FMA kernel
    elsewhere."""
    lib = load()
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    for tc in ((True, False) if is_bf16 and d % 16 == 0 else (False,)):
        per_sm = lib.rfe_union_scan_blocks_per_sm(d, int(is_bf16), cap, mode, int(tc))
        if per_sm > 0:
            return (tc, lib.rfe_union_scan_block_queries(int(tc)),
                    lib.rfe_union_scan_tile_rows(), per_sm * sms)
    raise RuntimeError(
        f"no union-scan launch fits dim {d} (cap {cap}): "
        + lib.rfe_union_scan_error_string(-per_sm).decode())


def query_tiles(qc: int, block_queries: int) -> Tuple[Tuple[int, int], ...]:
    """The stage-1 query tiles of a chunk of ``qc`` queries (grid z):
    (first query, queries) of each, every query in exactly one."""
    return tuple((q0, min(block_queries, qc - q0)) for q0 in range(0, qc, block_queries))


def plan_splits(base_blocks: int, u: int, capacity: int) -> Tuple[int, int]:
    """(union blocks per split, n_splits): the union axis is split so that
    (chunks x query tiles x slot tiles x splits) reaches ``_WAVES`` times
    the blocks the card holds at once, every split non-empty."""
    want = max(1, -(-_WAVES * capacity // max(base_blocks, 1)))
    per = -(-u // min(u, want))
    return per, -(-u // per)


def _kernel_scan(qv, u_all, codes3, rsq, ids, window, cap, metric, variant,
                 ktop):
    lib = load()
    chunks, qc, d = qv.shape
    u = u_all.shape[1]
    nbits = packing_bits(u)
    dev = qv.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    is_bf16 = qv.dtype == torch.bfloat16
    mode = 2 * (variant - 1) + int(metric != "L2")
    tc, tq, tn, capacity = _stage1(index, d, is_bf16, cap, mode)
    base = chunks * len(query_tiles(qc, tq)) * -(-window // tn)
    per_split, n_splits = plan_splits(base, u, capacity)
    part = torch.empty((chunks, qc, n_splits, cap, window), dtype=torch.int32, device=dev)
    if ktop:
        out = torch.empty((chunks, qc, KPAD), dtype=torch.int32, device=dev)
        lane = torch.empty((chunks, qc, KPAD), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((chunks, qc, cap * window), dtype=torch.int32, device=dev)
        lane = out  # unused
    err = lib.rfe_union_scan(
        qv.data_ptr(), u_all.data_ptr(), codes3.data_ptr(), rsq.data_ptr(),
        ids.data_ptr(), part.data_ptr(), out.data_ptr(), lane.data_ptr(),
        chunks, qc, d, u, window, cap, int(metric == "L2"), variant,
        int(is_bf16), nbits, init_packed(nbits), ktop, per_split, n_splits,
        KPAD, int(tc), torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError("union_scan kernel launch failed: "
                           + lib.rfe_union_scan_error_string(err).decode())
    union_scan.launches += 1
    union_scan.variant_launches[variant] += 1
    return (out, lane) if ktop else out


def union_scan(qs, u_all, codes3, sorted_sq, sorted_ids, *, window: int,
               cap: int, metric: str, variant: int = 1, ktop: int = 0):
    """Scan each chunk's union blocks; return PACKED candidates
    (chunks, qc, cap*window) int32, or with ``ktop`` (variant 2) a
    (packed, flat lane) pair of (chunks, qc, 128) int32. Decode with
    :func:`decode_topk` / :func:`decode_selected`.

    ``qs`` (chunks, qc, D) in the storage dtype (float32 or bfloat16);
    ``u_all`` (chunks, U) int32; ``codes3`` (nlist+1, window, D) storage;
    ``sorted_sq`` float32 and ``sorted_ids`` int32, one per slot."""
    _check_args(qs, u_all, codes3, sorted_sq, sorted_ids, window, cap,
                metric, variant, ktop)
    if codes3.device.type != "cuda":
        return union_scan_reference(qs, u_all, codes3, sorted_sq, sorted_ids,
                                    window=window, cap=cap, metric=metric,
                                    variant=variant, ktop=ktop)
    if qs.dtype != codes3.dtype or codes3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"union_scan takes float32 or bfloat16 queries and "
                        f"storage of one dtype, got {qs.dtype} and {codes3.dtype}")
    if u_all.dtype != torch.int32 or sorted_ids.dtype != torch.int32:
        raise TypeError("u_all and sorted_ids must be int32")
    for t in (qs, u_all, sorted_sq, sorted_ids):
        if t.device != codes3.device:
            raise ValueError("union_scan operands must share one device")
    # the kernel folds variant 2's dead rows into the norms as it stages
    # them; it launches on the card that holds the lists
    with torch.cuda.device(codes3.device):
        return _kernel_scan(_variant_queries(qs, metric, variant).contiguous(),
                            u_all.contiguous(), codes3.contiguous(),
                            sorted_sq.float().contiguous(), sorted_ids.contiguous(),
                            window, cap, metric, variant, ktop)


union_scan.launches = 0
union_scan.variant_launches = {1: 0, 2: 0}  # K2 / K3 launches


# ------------------------------------------------------------------ decode
def _decode(bv, lane, u_all, sorted_ids, qc, window):
    """Packed winners + their in-window lane -> (scores, global row ids),
    NEG_INF / -1 where invalid."""
    u = u_all.shape[1]
    mask_lo = (1 << packing_bits(u)) - 1
    jglob = (bv & mask_lo).long().clamp_max(u - 1)
    chunk = (torch.arange(bv.shape[0], device=bv.device) // qc)[:, None]
    blk = u_all[chunk, jglob].long()
    ids = sorted_ids[blk * window + lane.long()]
    vals = unmonotone_f32(bv & ~mask_lo)
    valid = (vals > 0.5 * NEG_INF) & (ids >= 0)
    vals = torch.where(valid, vals, torch.full_like(vals, NEG_INF))
    ids = torch.where(valid, ids, torch.full_like(ids, -1))
    return vals, ids


def decode_topk(packed, u_all, sorted_ids, *, window: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k per query over the packed candidates (ties to the lowest
    position, as ``small_topk`` / ``lax.top_k`` pick), then decode only the
    winners. Returns (scores, global row ids), both (chunks*qc, k), on the
    internal higher-better scale; invalid slots carry NEG_INF / id -1."""
    chunks, qc, capw = packed.shape
    k_eff = min(k, capw)
    flat = packed.reshape(chunks * qc, capw)
    if k_eff <= 16:
        bv, pos = small_topk(flat, k_eff)
    else:
        bv, pos = torch.sort(flat, dim=1, descending=True, stable=True)
        bv, pos = bv[:, :k_eff], pos[:, :k_eff]
    return _decode(bv, pos % window, u_all, sorted_ids, qc, window)


def decode_selected(packed_k, lanes, u_all, sorted_ids, *, window: int,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the in-kernel-selected top-k pairs (``ktop`` mode): the flat
    lane runs across the cap levels, so the slot in the window is
    ``lane % window``."""
    chunks, qc, kpad = packed_k.shape
    k_eff = min(k, kpad)
    bv = packed_k[..., :k_eff].reshape(chunks * qc, k_eff)
    lane = lanes[..., :k_eff].reshape(chunks * qc, k_eff) % window
    return _decode(bv, lane, u_all, sorted_ids, qc, window)
