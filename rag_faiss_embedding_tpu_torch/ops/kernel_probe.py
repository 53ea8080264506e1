"""Union-scan stage probe: the CUDA kernel and its plain version.

Port of ``benchmarks/pallas_kernel_probe.py`` (K6, ``make_kernel``).
``probe(variant, ...)`` scores each chunk's union blocks as the IVF union
scan does (``2 q.x - ||x||^2`` in float32, NEG_INF where the id is < 0),
packs every score with its block's union position (``b * bb + j``) into the
low ``packing_bits(U)`` bits, and selects four ways:

- ``"none"``: no selection; each of the ``cap`` levels holds the packed tile
  of the last block (U - 1);
- ``"chain"``: each (query, slot) bin keeps its top ``cap`` packed values by
  an int32 max/min chain over the U blocks in order (bins in shared memory,
  read and written back per block);
- ``"temps"``: the same chain with the bins in registers through a cell of
  ``bb`` blocks; the same bits as ``"chain"``;
- ``"temps_f32"``: the chain on the float32 view of the packed ints, with
  ``jnp.maximum`` / ``jnp.minimum`` semantics (a NaN wins). Negative packed
  ints order backwards as floats, so bins of negative scores stay at
  ``INIT``: the TPU probe's own semantics, which it timed and never checked.

Inputs: ``u_all`` (chunks, U) int32; ``qs`` (chunks, qc, D) bf16;
``codes3`` (nlist+1, window, D) bf16; ``aux3`` (nlist+1, 2, window) int32
(row 0 the float32 bits of ||x||^2, row 1 the ids). Output (chunks, qc,
cap * window) int32, level major.

- On CUDA tensors it launches ``csrc/kernel_probe.cu`` or raises. The
  kernel is chosen by shape before the launch: the tensor-core block (bf16
  ``mma.sync``, f32 accumulation) where D is a multiple of 16 and its
  shared memory fits, the FMA block elsewhere. Both walk the U blocks in
  order inside one CUDA block.
- On CPU tensors it runs ``probe_reference``.

The plain version sums each score's exact bf16 products in column order
(``ordered_dot``): the FMA block's order, so the two agree bit for bit. The
tensor cores sum in another order, so a packed value of the tensor-core
block may differ from the plain version's by float32 rounding and, where two
blocks' scores of one bin are that close, carry the other block's position.

``probe.launches`` counts kernel launches, ``probe.variant_launches`` splits
them by variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .distance import NEG_INF
from .fused_proto import ordered_dot
from .union_scan import MAX_CAP, init_packed, mono_i32, packing_bits

__all__ = ["probe", "probe_reference", "VARIANTS"]

VARIANTS = ("none", "chain", "temps", "temps_f32")


def _check_args(variant, u_all, qs, codes3, aux3, bb, cap):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if qs.ndim != 3 or codes3.ndim != 3 or u_all.ndim != 2:
        raise ValueError("qs, codes3 must be 3-d and u_all 2-d")
    chunks, _, d = qs.shape
    nblocks, window, dc = codes3.shape
    if dc != d or aux3.shape != (nblocks, 2, window):
        raise ValueError(f"codes3 {tuple(codes3.shape)} / aux3 {tuple(aux3.shape)} do not "
                         f"match queries of dim {d}")
    if u_all.shape[0] != chunks:
        raise ValueError("u_all needs one row per chunk")
    if bb < 1 or u_all.shape[1] % bb:
        raise ValueError(f"U={u_all.shape[1]} must be a multiple of bb={bb}")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"cap must be in 1..{MAX_CAP}, got {cap}")


def _nan_max(a, b):
    """``jnp.maximum`` on float32: a NaN operand wins, the first if both."""
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, torch.maximum(a, b)))


def _nan_min(a, b):
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, torch.minimum(a, b)))


def probe_reference(variant: str, u_all, qs, codes3, aux3, *, bb: int,
                    cap: int) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: all packed scores
    summed in column order (``ordered_dot``), then the chain over the U
    blocks in order."""
    _check_args(variant, u_all, qs, codes3, aux3, bb, cap)
    chunks, qc, d = qs.shape
    window = codes3.shape[1]
    u = u_all.shape[1]
    nbits = packing_bits(u)
    blocks = u_all.long()
    rows = codes3[blocks].float()                               # (chunks, U, window, D)
    aux = aux3[blocks]                                          # (chunks, U, 2, window)
    rsq = aux[:, :, 0].contiguous().view(torch.float32)[:, None]
    rid = aux[:, :, 1][:, None]
    s = 2.0 * ordered_dot(qs.float()[:, :, None, None], rows[:, None]) - rsq
    s = torch.where(rid >= 0, s, NEG_INF)
    jglob = torch.arange(u, dtype=torch.int32, device=qs.device)[None, None, :, None]
    packed = (mono_i32(s) & ~((1 << nbits) - 1)) | jglob       # (chunks, qc, U, window)
    if variant == "none":
        levels = [packed[:, :, -1]] * cap
    elif variant == "temps_f32":
        init = torch.tensor(init_packed(nbits), dtype=torch.int32).view(torch.float32)
        levels = [torch.full((chunks, qc, window), float(init), device=qs.device)] * cap
        flt = packed.view(torch.float32)
        for ub in range(u):
            t = flt[:, :, ub]
            for lvl in range(cap):
                cur = levels[lvl]
                levels[lvl], t = _nan_max(cur, t), _nan_min(cur, t)
        levels = [lv.view(torch.int32) for lv in levels]
    else:  # chain and temps: the same chain
        levels = [torch.full((chunks, qc, window), init_packed(nbits), dtype=torch.int32,
                             device=qs.device)] * cap
        for ub in range(u):
            t = packed[:, :, ub]
            for lvl in range(cap):
                cur = levels[lvl]
                levels[lvl], t = torch.maximum(cur, t), torch.minimum(cur, t)
    return torch.cat(levels, dim=-1)


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    points."""
    lib = _build.load("kernel_probe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rfe_kernel_probe.argtypes = [ci] + [vp] * 5 + [ci] * 9 + [vp]
    lib.rfe_kernel_probe.restype = ci
    lib.rfe_kernel_probe_max_cap.argtypes = []
    lib.rfe_kernel_probe_max_cap.restype = ci
    lib.rfe_kernel_probe_tile_rows.argtypes = []
    lib.rfe_kernel_probe_tile_rows.restype = ci
    lib.rfe_kernel_probe_tc_fits.argtypes = [ci, ci]
    lib.rfe_kernel_probe_tc_fits.restype = ci
    lib.rfe_kernel_probe_error_string.argtypes = [ci]
    lib.rfe_kernel_probe_error_string.restype = ctypes.c_char_p
    if lib.rfe_kernel_probe_max_cap() != MAX_CAP:
        raise RuntimeError(f"kernel_probe.cu has MAX_CAP={lib.rfe_kernel_probe_max_cap()}, "
                           f"ops/kernel_probe.py has {MAX_CAP}")
    return lib


@functools.lru_cache(maxsize=None)
def uses_tensor_cores(device_index: int, d: int, cap: int) -> bool:
    """Whether ``probe`` runs the tensor-core block for width ``d`` and
    ``cap`` on the card (else the FMA block): D a multiple of 16 whose block
    fits in the card's shared memory. The kernel's entry point makes the
    same choice by shape before its launch; this asks it, for reporting."""
    lib = load()
    with torch.cuda.device(device_index):
        fits = lib.rfe_kernel_probe_tc_fits(d, cap)
    if fits < 0:
        raise RuntimeError("kernel_probe: " + lib.rfe_kernel_probe_error_string(-fits).decode())
    return bool(fits)


def probe(variant: str, u_all, qs, codes3, aux3, *, bb: int, cap: int) -> torch.Tensor:
    """One probe call: (chunks, qc, cap * window) int32 packed bins (see the
    module docstring for the four variants)."""
    _check_args(variant, u_all, qs, codes3, aux3, bb, cap)
    if codes3.device.type != "cuda":
        return probe_reference(variant, u_all, qs, codes3, aux3, bb=bb, cap=cap)
    if qs.dtype != torch.bfloat16 or codes3.dtype != torch.bfloat16:
        raise TypeError(f"probe takes bfloat16 queries and rows, got {qs.dtype} and "
                        f"{codes3.dtype}")
    if u_all.dtype != torch.int32 or aux3.dtype != torch.int32:
        raise TypeError("u_all and aux3 must be int32")
    for t in (qs, u_all, aux3):
        if t.device != codes3.device:
            raise ValueError("probe operands must share one device")
    lib = load()
    chunks, qc, d = qs.shape
    window = codes3.shape[1]
    u = u_all.shape[1]
    if d % 8 or window % lib.rfe_kernel_probe_tile_rows():
        raise ValueError(f"the kernel needs D % 8 == 0 and window % "
                         f"{lib.rfe_kernel_probe_tile_rows()} == 0, got {d}, {window}")
    qs, u_all = qs.contiguous(), u_all.contiguous()
    codes3, aux3 = codes3.contiguous(), aux3.contiguous()
    nbits = packing_bits(u)
    dev = qs.device
    out = torch.empty((chunks, qc, cap * window), dtype=torch.int32, device=dev)
    err = lib.rfe_kernel_probe(
        VARIANTS.index(variant), qs.data_ptr(), u_all.data_ptr(), codes3.data_ptr(),
        aux3.data_ptr(), out.data_ptr(), chunks, qc, d, u, window, bb, cap, nbits,
        init_packed(nbits), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("kernel_probe launch failed: "
                           + lib.rfe_kernel_probe_error_string(err).decode())
    probe.launches += 1
    probe.variant_launches[variant] += 1
    return out


probe.launches = 0
probe.variant_launches = dict.fromkeys(VARIANTS, 0)
