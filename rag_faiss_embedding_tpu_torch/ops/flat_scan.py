"""Fused distance + top-k flat scan: the CUDA kernel and its plain version.

Port of ``rag_faiss_embedding_tpu/ops/pallas_scan.py`` (K1, ``_scan_kernel``).
``flat_search`` keeps that function's contract: exact top-k over the first
``n_valid`` rows of ``db``, float32 accumulation, ties to the lowest row
index, (values, indices) with squared-L2 distances ascending or inner
products descending, and index -1 with inf / -inf in slots no live row
fills (also when ``k`` exceeds ``n_valid`` inside a padded buffer).

- On a CUDA tensor it launches ``csrc/flat_scan.cu`` (built on first use by
  ``_build``) or raises: stage 1 scans, stage 2 merges and writes the public
  values, and no other device work follows. The tile sizes are the kernel's
  own, so the TPU version's ``tile_q`` / ``tile_n`` / ``interpret``
  arguments are gone. Any width D fits (wide rows are staged in column
  chunks), and any k: stage 1 takes one of two paths by the number of
  queries and k (``choose_path``), one query per warp (any k) or the
  register-tiled block of 128 queries x 128 rows (k <= ``KMAX``). Above
  ``KMAX`` each split covers at least ``LONG_ROWS_PER_K`` x k rows, and
  lists too long for shared memory live in global memory.
- ``dead`` (optional, bool, True = never returned) masks rows inside the
  kernel: tombstones and filters take the same route as a plain search.
- On a CPU tensor it runs ``flat_search_reference``, the same contract in
  plain torch (``ops/distance.exact_search``).

``flat_search.launches`` counts kernel launches (one per call that reaches
the card), so a run can show that its searches went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .distance import as_tensor, exact_search, sqnorms

# stage-1 blocks to aim for, in waves of what the card holds at once: with
# several waves the last, partly filled one costs little. The tiled path
# takes one wave: each split's first tiles fill its lists, so more splits
# cost more insertions (``benchmarks/scan_kernels.py --waves`` times it)
_WAVES = 8
_TILED_WAVES = 1
# largest k of the tiled path and of the lists that shift through
# registers: csrc/flat_scan.cu's KMAX (load() checks that the two agree)
KMAX = 64
# above KMAX, the fewest rows per stage-1 split, in units of k: a split's
# list fills from its first k rows, and stage 2 merges k per split
LONG_ROWS_PER_K = 8
# column chunks tried, widest first, when a whole row does not fit a tile
_CHUNK_COLS = (1024, 512, 256, 128)
# stage-1 paths (csrc/flat_scan.cu's Path)
WARP, TILED = 0, 1
PATHS = {"warp": WARP, "tiled": TILED}
# fewest queries that take the tiled path: the crossover measured on an
# H100 over 1M x 384 float32 rows (PERF.md, the kernel table's findings;
# chip_smoke.py times both paths at each of its CROSSOVER_Q)
TILED_MIN_Q = 25


def choose_path(nq: int, k: int = 1) -> int:
    """The stage-1 path for ``nq`` queries and ``k`` hits: one query per
    warp below ``TILED_MIN_Q`` (each block of 8 queries reads the database
    once, and the tiled block's 128 query rows would be mostly padding) or
    above ``KMAX`` (the tiled block holds 128 lists of k in shared memory),
    the tiled block otherwise."""
    return TILED if nq >= TILED_MIN_Q and k <= KMAX else WARP


def flat_search_reference(
    q: torch.Tensor,
    db: torch.Tensor,
    k: int,
    *,
    metric: str = "L2",
    db_sq: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    dead: Optional[torch.Tensor] = None,
    chunk_size: int = 524288,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel, on any device; ``chunk_size``
    rows per step."""
    return exact_search(q, db, k, metric=metric, db_sq=db_sq, n_valid=n_valid,
                        chunk_size=chunk_size, dead=dead)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    points."""
    lib = _build.load("flat_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rfe_flat_scan.argtypes = [vp] * 8 + [ci] * 13 + [vp]
    lib.rfe_flat_scan.restype = ci
    lib.rfe_flat_scan_kmax.argtypes = []
    lib.rfe_flat_scan_kmax.restype = ci
    lib.rfe_flat_scan_tile_rows.argtypes = [ci]
    lib.rfe_flat_scan_tile_rows.restype = ci
    lib.rfe_flat_scan_block_queries.argtypes = [ci]
    lib.rfe_flat_scan_block_queries.restype = ci
    lib.rfe_flat_scan_blocks_per_sm.argtypes = [ci] * 7
    lib.rfe_flat_scan_blocks_per_sm.restype = ci
    lib.rfe_cuda_error_string.argtypes = [ci]
    lib.rfe_cuda_error_string.restype = ctypes.c_char_p
    if lib.rfe_flat_scan_kmax() != KMAX:
        raise RuntimeError(
            f"flat_scan.cu has KMAX={lib.rfe_flat_scan_kmax()}, "
            f"ops/flat_scan.py has {KMAX}")
    return lib


def chunk_widths(d: int) -> Tuple[int, ...]:
    """Column counts the kernel may stage at once for width ``d``, widest
    first: the whole row (padded to 4), then the narrower chunks."""
    d4 = -(-d // 4) * 4
    return (d4,) + tuple(c for c in _CHUNK_COLS if c < d4)


def plan_splits(nq: int, n_rows: int, block_queries: int, tile_rows: int,
                capacity: int, waves: int = _WAVES,
                min_rows: int = 0) -> Tuple[int, int]:
    """(rows_per_split, n_splits) for stage 1. Q tiles alone give one block
    at Q = 1, so the database is split too, aiming at ``waves`` times the
    ``capacity`` (blocks the card holds at once), with every split a whole
    number of tiles, none empty, and none under ``min_rows`` rows where the
    database has them."""
    q_blocks = -(-nq // block_queries)
    n_tiles = -(-n_rows // tile_rows)
    want = max(1, -(-waves * capacity // q_blocks))
    tiles_per_split = min(n_tiles, max(-(-n_tiles // want), -(-min_rows // tile_rows)))
    n_splits = -(-n_tiles // tiles_per_split)
    return tiles_per_split * tile_rows, n_splits


@functools.lru_cache(maxsize=None)
def _launch_shape(device_index: int, d: int, k: int, is_l2: bool,
                  is_bf16: bool, path: int) -> Tuple[int, int, int]:
    """(columns per chunk, lists in global memory, blocks the card holds at
    once) for a shape and path, chosen before any launch. The tiled path
    stages 16 columns at a time whatever D is; the one-query-per-warp path
    takes the widest chunk that fits with its lists in shared memory, and
    only where none does (k in the thousands) keeps them in global memory."""
    lib = load()
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    for glist in ((0,) if path == TILED else (0, 1)):
        for dc in ((0,) if path == TILED else chunk_widths(d)):
            per_sm = lib.rfe_flat_scan_blocks_per_sm(d, k, is_l2, is_bf16, path, dc, glist)
            if per_sm > 0:
                return dc, glist, per_sm * sms
    raise RuntimeError(f"no flat-scan launch shape fits dim {d}, k={k}")


def _kernel_search(q, db, db_sq, dead, n_rows: int, k: int, k_out: int, metric: str,
                   path: int):
    lib = load()
    nq, d = q.shape
    dev = db.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    is_l2, is_bf16 = metric == "L2", db.dtype == torch.bfloat16
    dc, glist, capacity = _launch_shape(index, d, k, is_l2, is_bf16, path)
    rows_per_split, n_splits = plan_splits(
        nq, n_rows, lib.rfe_flat_scan_block_queries(path),
        lib.rfe_flat_scan_tile_rows(path), capacity,
        _TILED_WAVES if path == TILED else _WAVES,
        LONG_ROWS_PER_K * k if k > KMAX else 0)
    vec = int(d % (8 if is_bf16 else 4) == 0 and db.data_ptr() % 16 == 0
              and q.data_ptr() % 16 == 0)
    # two allocations (scratch; values and ids): on the single-request path
    # the host's work, not the card's, sets the time
    part = torch.empty(2 * nq * n_splits * k, dtype=torch.int32, device=dev)
    out = torch.empty((2, nq, k_out), dtype=torch.int32, device=dev)
    p, o = part.data_ptr(), out.data_ptr()
    err = lib.rfe_flat_scan(
        q.data_ptr(), db.data_ptr(), db_sq.data_ptr() if is_l2 else None,
        None if dead is None else dead.data_ptr(),
        p, p + 4 * nq * n_splits * k, o, o + 4 * nq * k_out,
        nq, n_rows, d, k, k_out, int(is_l2), int(is_bf16), path, dc,
        rows_per_split, n_splits, vec, glist, torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(
            "flat_scan kernel launch failed: "
            + lib.rfe_cuda_error_string(err).decode())
    flat_search.launches += 1
    return out[0].view(torch.float32), out[1]


def flat_search(
    q,
    db,
    k: int,
    *,
    metric: str = "L2",
    db_sq=None,
    n_valid: Optional[int] = None,
    dead=None,
    chunk_size: int = 524288,
    path: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fused top-k scan; same contract as ``ops.distance.exact_search``.

    ``q`` (Q, D) and ``db`` (N, D) share a dtype (float32 or bfloat16);
    ``db_sq`` is the float32 row squared norms (computed if omitted, for
    L2); rows >= ``n_valid`` are padding; ``dead`` (N,) bool marks rows
    that never come back (tombstones, filters). ``chunk_size`` is the plain
    version's rows per step (CPU tensors). ``path`` ("warp" or "tiled")
    forces a stage-1 path on the card, to measure the paths against each
    other; by default ``choose_path`` picks it.
    """
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    db = as_tensor(db)
    q = as_tensor(q, device=db.device)
    if db.device.type != "cuda":
        return flat_search_reference(q, db, k, metric=metric, db_sq=db_sq,
                                     n_valid=n_valid, dead=dead, chunk_size=chunk_size)
    if q.dtype != db.dtype or db.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"flat_search takes float32 or bfloat16 q and db of one dtype, "
            f"got {q.dtype} and {db.dtype}")
    n, d = db.shape
    nq = q.shape[0]
    if q.shape[1] != d:
        raise ValueError(f"query dim {q.shape[1]} != database dim {d}")
    q, db = q.contiguous(), db.contiguous()
    if metric == "L2":
        db_sq = sqnorms(db) if db_sq is None else db_sq
        db_sq = as_tensor(db_sq, db.device, torch.float32).contiguous()
    n_rows = n if n_valid is None else max(0, min(int(n_valid), n))
    k_eff = min(k, n)
    if dead is not None:
        dead = as_tensor(dead, db.device, torch.bool).contiguous()
        if dead.shape[0] < n_rows:
            raise ValueError(f"dead has {dead.shape[0]} entries for {n_rows} rows")
    path_id = choose_path(nq, k_eff) if path is None else PATHS[path]
    if path_id == TILED and k_eff > KMAX:
        raise ValueError(f"the tiled path holds k <= KMAX={KMAX}, got k={k_eff}")

    if nq == 0 or n_rows == 0 or k_eff == 0:  # no row to return
        fill = float("inf") if metric == "L2" else float("-inf")
        return (torch.full((nq, k), fill, device=db.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=db.device))
    return _kernel_search(q, db, db_sq, dead, n_rows, k_eff, k, metric, path_id)


flat_search.launches = 0
