"""PQ decode: the CUDA kernel and its plain version.

Port of ``rag_faiss_embedding_tpu/ops/pallas_pq.py`` (K4, ``_decode_kernel``).
``decode(codebooks, codes)`` turns (N, M) uint8 codes into (N, M * dsub)
rows in the codebook's dtype: row r's subspace s is codeword
``codebooks[s, codes[r, s]]``, bit for bit.

- On a CUDA tensor it launches ``csrc/pq_decode.cu`` (built on first use by
  ``_build``) or raises. The TPU kernel multiplies one-hot tiles by a
  block-diagonal grouped bf16 codebook, a workaround for the TPU's missing
  gathers; on the card the decode is a gather, so ``grouped_codebook`` /
  ``pick_group`` and the JAX eligibility gate (``g * dsub == 128``, N % 128
  == 0) have no counterpart: any N >= 0, any M, ksub <= 256. The codebook
  may be bfloat16 (``compute_dtype="bf16"``) or float32 (``"f32"``).
- On a CPU tensor it runs ``decode_reference``, the gather of
  ``ops/pq._decode_bf16`` (one flat index over the (M * ksub, dsub) table).
- ``plan`` chooses the launch from N and the codebook's shape, in Python so
  that the CPU tests reach it: whether the codebook is staged in shared
  memory (on a band of N, ``staged_rows``, and never more staged bytes than
  the launch writes) or gathered through L2, the subspace groups, rows per
  tile, threads and grid.

``decode.launches`` counts kernel launches (N = 0 launches nothing).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ESIZE = {torch.bfloat16: 2, torch.float32: 4}

# The H100's limits the plan is held to: dynamic shared memory one block may
# use, shared memory on an SM (each resident block also reserves 1 KiB),
# threads and 32-bit registers on an SM, and the SM count.
SMEM_LIMIT = 232448
SM_SMEM = 233472
SM_THREADS = 2048
SM_REGS = 65536
SMS = 132
MAX_THREADS = 1024
REGS_PER_THREAD = 32  # the most __launch_bounds__(1024, 2) leaves a thread

# The band of N where each block stages its codebook slice in shared memory:
# from STAGED_MIN_ROWS rows while the rows written stay under
# STAGED_MAX_BYTES. Outside it the kernel gathers through L2 and L1. Below
# the band staging costs a block more than its few rows; above it the L1s
# hold the codebook anyway and the unstaged blocks, which use no shared
# memory, keep more warps in flight. Device time at M 48, ksub 256, dsub 8,
# L2 against staged, in us (benchmarks/scan_kernels.py --k4-crossover on an
# NVIDIA H100 80GB HBM3 at 700 W): bf16 4,096 rows 3.79 / 4.06, 6,144 4.78 /
# 4.33, 16,384 8.32 / 6.62, 40,960 (31.5 MB) 14.52 / 13.58, 49,152 16.53 /
# 20.16; f32 4,096 4.28 / 4.63, 8,192 6.68 / 6.47, 16,384 11.09 / 10.84,
# 24,576 (37.7 MB) 14.71 / 17.68.
STAGED_MIN_ROWS = 6144
STAGED_MAX_BYTES = 32 << 20
# Staged launches: the codebook slice a block stages at most (the subspace
# groups follow), about this many threads a block, rows a thread walks per
# tile.
STAGED_SLICE_BYTES = 24 * 1024
STAGED_THREADS = 256
STAGED_PASSES = 8
# Unstaged launches: about this many threads a block, and each thread walks
# up to this many rows of a tile (independent loads in flight).
L2_THREADS = 256
L2_PASSES = 4

_PLAN_FIELDS = ("m", "ksub", "dsub", "esize", "device", "staged", "groups", "per_group",
                "tile_rows", "tw", "threads", "grid_x", "smem_bytes")


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
    lib.rfe_pq_decode.argtypes = [vp] * 3 + [ci, ctypes.POINTER(ci), vp]
    lib.rfe_pq_decode.restype = ci
    lib.rfe_pq_decode_plan_fields.restype = ci
    lib.rfe_pq_decode_error_string.argtypes = [ci]
    lib.rfe_pq_decode_error_string.restype = ctypes.c_char_p
    if lib.rfe_pq_decode_plan_fields() != len(_PLAN_FIELDS):
        raise RuntimeError("csrc/pq_decode.cu reads another plan than ops/pq_decode.py makes")
    return lib


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _chunk_bytes(sub_bytes: int) -> int:
    """Widest store (16, 8, 4 or 2 bytes) that divides a subvector."""
    return next(vb for vb in (16, 8, 4, 2) if sub_bytes % vb == 0)


def _blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` dynamic shared bytes that
    one SM holds at once, registers counted at the launch bound's most."""
    return max(1, min(SM_SMEM // (smem + 1024), SM_THREADS // threads,
                      SM_REGS // (threads * REGS_PER_THREAD)))


def plan(m: int, ksub: int, dsub: int, dtype: torch.dtype, n: int | None = None, *,
         sms: int = SMS, smem_limit: int = SMEM_LIMIT) -> dict:
    """The kernel's launch for ``n`` rows (default 1,048,576) of (m, ksub,
    dsub) codebooks of ``dtype`` on a card of ``sms`` SMs whose blocks may
    use ``smem_limit`` bytes of shared memory: ``staged`` (each block copies
    its group's codebook slice, ``smem_bytes``, into shared memory) or not,
    subspace ``groups`` (grid y) of ``per_group`` subspaces, ``tile_rows``
    per tile, ``threads`` a block (``tw`` chunks of a row across, ``threads
    // tw`` rows down) and ``grid_x`` row-tile walkers. Also
    ``staged_bytes`` (codebook bytes the launch copies into shared memory)
    and ``out_bytes`` (the rows it writes)."""
    if dtype not in _ESIZE:
        raise TypeError(f"pq_decode takes bfloat16 or float32 codebooks, got {dtype}")
    if m < 1 or not 1 <= ksub <= 256 or dsub < 1:
        raise ValueError(f"pq_decode takes no codebook of shape ({m}, {ksub}, {dsub})")
    n = 1 << 20 if n is None else int(n)
    sub = dsub * _ESIZE[dtype]
    cps = sub // _chunk_bytes(sub)  # chunks a subvector
    word = ksub * sub               # one subspace's codebook
    out_bytes = n * m * sub

    def block(mg: int, threads: int, passes: int) -> tuple:
        tw = min(mg * cps, MAX_THREADS)
        rp = max(1, threads // tw)
        return tw, tw * rp, rp * passes

    # staged: slices of at most STAGED_SLICE_BYTES (and what a block may
    # use); the walkers of each group stage it once each, so they are held
    # to the bytes the launch writes
    slice_cap = min(STAGED_SLICE_BYTES, smem_limit)
    mg = max(1, min(m, slice_cap // word))
    if (n >= STAGED_MIN_ROWS and out_bytes < STAGED_MAX_BYTES
            and _round16(mg * word) <= smem_limit):
        groups = -(-m // mg)
        mg = -(-m // groups)  # even groups
        cb_smem = _round16(mg * word)
        tw, threads, tile_rows = block(mg, STAGED_THREADS, STAGED_PASSES)
        walkers = min(-(-n // tile_rows),
                      sms * _blocks_per_sm(threads, cb_smem) // groups,
                      out_bytes // (groups * cb_smem))
        if walkers >= 1:
            return dict(staged=1, groups=groups, per_group=mg, tile_rows=tile_rows, tw=tw,
                        threads=threads, grid_x=walkers, smem_bytes=cb_smem,
                        staged_bytes=walkers * groups * cb_smem, n=n, out_bytes=out_bytes)

    # gathered through L2: one group, a tile per block; tiles small enough
    # that the grid covers the SMs wherever N allows
    tw, threads, tile_rows = block(m, L2_THREADS, L2_PASSES)
    rp = threads // tw
    tile_rows = max(rp, min(tile_rows, n // sms // rp * rp))
    return dict(staged=0, groups=1, per_group=m, tile_rows=tile_rows, tw=tw, threads=threads,
                grid_x=max(1, -(-n // tile_rows)), smem_bytes=0, staged_bytes=0, n=n,
                out_bytes=out_bytes)


def staged_rows(m: int, ksub: int, dsub: int, dtype: torch.dtype, **card) -> range | None:
    """The row counts N at which ``plan`` stages the codebook (one band, its
    two ends the crossovers), or None where it never does; ``card``:
    ``plan``'s ``sms`` / ``smem_limit``."""
    hi = -(-STAGED_MAX_BYTES // (m * dsub * _ESIZE[dtype]))
    if hi <= STAGED_MIN_ROWS or not plan(m, ksub, dsub, dtype, hi - 1, **card)["staged"]:
        return None
    lo, top = STAGED_MIN_ROWS - 1, hi - 1  # plan(lo) unstaged, plan(top) staged
    while top - lo > 1:
        mid = (lo + top) // 2
        if plan(m, ksub, dsub, dtype, mid, **card)["staged"]:
            top = mid
        else:
            lo = mid
    return range(top, hi)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple:
    """(SMs, shared bytes a block may use) of card ``index``."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


@functools.lru_cache(maxsize=4096)
def _plan_fields(n: int, m: int, ksub: int, dsub: int, dtype: torch.dtype, index: int):
    """``plan`` for card ``index`` as the C entry point's int array."""
    sms, smem = _card(index)
    p = plan(m, ksub, dsub, dtype, n, sms=sms, smem_limit=smem)
    p.update(m=m, ksub=ksub, dsub=dsub, esize=_ESIZE[dtype], device=index)
    return (ctypes.c_int * len(_PLAN_FIELDS))(*(p[k] for k in _PLAN_FIELDS))


def decode(codebooks: torch.Tensor, codes: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Decode (N, M) uint8 codes against (M, ksub, dsub) bfloat16 or float32
    codebooks into (N, M * dsub) rows of the codebook's dtype, written into
    ``out`` (contiguous, of that shape and dtype) where one is given."""
    if codebooks.ndim != 3 or codes.ndim != 2 or codes.shape[1] != codebooks.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} do not match codebooks "
                         f"{tuple(codebooks.shape)}")
    m, ksub, dsub = codebooks.shape
    n = codes.shape[0]
    dtype = codebooks.dtype
    index = codes.get_device()  # -1 on the CPU; cheaper than .device
    if out is not None and (out.shape != (n, m * dsub) or out.dtype != dtype
                            or out.get_device() != index or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({n}, {m * dsub}) {dtype} tensor on "
                         f"{codes.device}")
    if index < 0:
        rows = decode_reference(codebooks, codes)
        return rows if out is None else out.copy_(rows)
    if dtype not in _ESIZE or codes.dtype != torch.uint8:
        raise TypeError(f"pq_decode takes uint8 codes and bfloat16 or float32 "
                        f"codebooks, got {codes.dtype} and {dtype}")
    if not 1 <= ksub <= 256:
        raise ValueError(f"ksub must be in 1..256, got {ksub}")
    if codebooks.get_device() != index:
        raise ValueError("pq_decode operands must share one device")
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if not codebooks.is_contiguous():
        codebooks = codebooks.contiguous()
    if out is None:
        out = torch.empty((n, m * dsub), dtype=dtype, device=index)
    if n == 0:
        return out
    lib = load()
    fields = _plan_fields(n, m, ksub, dsub, dtype, index)
    if index == torch.cuda.current_device():
        err = lib.rfe_pq_decode(codes.data_ptr(), codebooks.data_ptr(), out.data_ptr(), n,
                                fields, torch._C._cuda_getCurrentRawStream(index))
    else:  # launch on the card that holds the codes
        with torch.cuda.device(index):
            err = lib.rfe_pq_decode(codes.data_ptr(), codebooks.data_ptr(), out.data_ptr(), n,
                                    fields, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError("pq_decode kernel launch failed: "
                           + lib.rfe_pq_decode_error_string(err).decode())
    decode.launches += 1
    return out


decode.launches = 0
