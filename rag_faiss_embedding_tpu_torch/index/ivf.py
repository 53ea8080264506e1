"""IVF-Flat index: k-means coarse quantizer + inverted-list scan.

Counterpart of ``rag_faiss_embedding_tpu/index/ivf.py`` (the
``faiss.IndexIVFFlat`` analog) for float32 / bfloat16 storage, with the same
layout, arguments and file format:

- vectors live on ``device`` in a BLOCK-PADDED buffer: every list owns
  ``window`` slots, plus one all-dead sentinel block at list ``nlist``; dead
  slots carry id -1, so probing list l reads rows l*window .. +window;
- ``balance="spill"`` caps the window at a list-length quantile and sends
  the overflow to an exactly scanned pending tier (the port's
  ``FlatIndex``); ``balance="reassign"`` runs the capacity-capped
  multi-choice assignment, then rescues rows that exhausted their choices;
- streaming adds land in the pending tier, merged by ``rebuild()``;
- search is the fused batched path of ``ops/ivf_scan.py``: on a CUDA index
  ``backend="auto"`` launches the union-scan kernel (``csrc/union_scan.cu``)
  or raises; a filter takes the plain chunk body, as in JAX;
- IVF-PQ (``pq_m``, the FAISS ``IndexIVFPQ`` analog): lists hold M-byte
  residual codes of (x - centroid), optionally OPQ-rotated (``pq_opq``),
  with exact ||c + r̂||^2 norms; the pending tier stays dense bfloat16. The
  scan decodes through the PQ decode kernel (``csrc/pq_decode.cu``) on a
  CUDA index unless ``backend="xla"``. ``rerank=True`` keeps a compact
  refine shadow (int8 by default, or bfloat16 / float32 rows, plus a
  slot -> row map) and re-scores the top ``rerank_depth`` ADC candidates;
- ``state_dict`` writes the JAX package's "padded_v3" npz layout, so an
  index saved by either package loads in the other.

``remove_ids`` writes -1 into the block ids in place on the device.

Not ported yet: dense int8 storage and ``rerank`` without ``pq_m`` (the
int8 tier), and ``build_chunked`` (the out-of-memory IVF-PQ build). The
per-query windowed search (``use_fused=False``) is not ported:
``probe_scan_math`` is kept only as a test oracle.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.logging import get_logger

from .. import default_device
from ..ops import distance as dist_ops
from ..ops import pq as pq_ops
from ..ops.ivf_scan import fused_ivf_search, resolve_fused_dispatch
from ..ops.kmeans import assign as kmeans_assign, assign_topk, spatial_order, train_kmeans
from ..ops.quantize import dequantize, quantize_rows
from . import codec
from .flat import _DTYPES, FlatIndex, _dtype_name, _round_up

logger = get_logger(__name__)

_INT8_TIER = "the int8 tier"
# the npz dtype tag of each refine shadow saved as raw values (bf16 saves as
# uint16 bits)
_SHADOW_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32}


def probe_scan_math(q, sorted_vecs, sorted_sq, sorted_ids, offsets, lengths,
                    probe_lists, filt=None, *, k: int, window: int):
    """Per-query fixed-window masked probe scan (L2): the semantics
    reference of the fused search, kept as a test oracle."""
    nq, d = q.shape
    p = probe_lists.shape[1]
    starts = offsets[probe_lists]
    lens = lengths[probe_lists]
    slot = torch.arange(window, device=q.device)
    idx = starts[:, :, None] + slot[None, None, :]
    valid = slot[None, None, :] < lens[:, :, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx)).long()
    vecs = sorted_vecs[idx].float()
    ids = torch.where(valid, sorted_ids[idx], torch.full_like(idx, -1, dtype=torch.int32))
    dots = torch.einsum("qd,qpcd->qpc", q.float(), vecs)
    dist = (q.float() ** 2).sum(-1)[:, None, None] - 2.0 * dots + sorted_sq[idx]
    live = valid & (ids >= 0)
    if filt is not None:
        live = live & filt[ids.clamp_min(0).long()]
    dist = torch.where(live, dist.clamp_min(0.0), torch.full_like(dist, float("inf")))
    best, pos = dist_ops.small_topk(-dist.reshape(nq, p * window), min(k, p * window))
    out_ids = torch.gather(ids.reshape(nq, p * window), 1, pos.long())
    out_dist = -best
    return out_dist, torch.where(torch.isinf(out_dist), torch.full_like(out_ids, -1), out_ids)


def balanced_assignment(choices: np.ndarray, scores: np.ndarray, nlist: int,
                        cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-capped assignment: each point takes its best-choice list
    with room, the closest points first when a list overflows (evicted ones
    fall back to their next choice). Returns (assignments (N,), rows that
    exhausted every choice). A copy of the JAX package's host pass."""
    n = len(choices)
    assignment = np.full(n, -1, np.int64)
    capacity = np.full(nlist, cap, np.int64)
    pending = np.arange(n)
    for c in range(choices.shape[1]):
        if not len(pending):
            break
        lists = choices[pending, c].astype(np.int64)
        order = np.lexsort((scores[pending, c], lists))
        lp = lists[order]
        first = np.r_[True, lp[1:] != lp[:-1]] if len(lp) else np.zeros(0, bool)
        group_start = np.maximum.accumulate(np.where(first, np.arange(len(lp)), 0))
        rank = np.arange(len(lp)) - group_start
        ok = rank < capacity[lp]
        sel = pending[order[ok]]
        assignment[sel] = lp[ok]
        capacity -= np.bincount(lp[ok], minlength=nlist)
        pending = pending[order[~ok]]
    return assignment, pending


class IVFFlatIndex:
    """Inverted-file flat index with exact within-list distances."""

    def __init__(
        self,
        dim: int,
        nlist: int = 1024,
        metric: str = "L2",
        nprobe: int = 8,
        dtype: str | torch.dtype = "float32",
        device: Optional[torch.device | str] = None,
        train_iters: int = 20,
        seed: int = 0,
        recall_target: Optional[float] = None,
        balance: str = "spill",
        reassign_choices: int = 16,
        union_cap: Optional[int] = None,
        balance_weight: float = 0.0,
        rerank: Optional[bool] = None,
        rerank_depth: Optional[int] = None,
        refine_dtype: str = "int8",
        union_mode: str = "auto",
        backend: str = "auto",
        pallas_cap: int = 2,
        pallas_variant: int = 1,
        pq_m: Optional[int] = None,
        pq_ksub: int = 256,
        pq_compute: str = "bf16",
        pq_opq: bool = False,
    ):
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        if balance not in ("spill", "reassign"):
            raise ValueError(f"balance must be 'spill' or 'reassign', got {balance!r}")
        if refine_dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"bad refine_dtype {refine_dtype!r}")
        if union_mode not in ("auto", "minrank", "chunkmax"):
            raise ValueError(f"bad union_mode {union_mode!r}")
        if backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"bad backend {backend!r}")
        self.dim = int(dim)
        self.nlist = int(nlist)
        self.metric = metric
        self.nprobe = int(nprobe)
        # IVF-PQ: lists hold M-byte residual codes (x - centroid), optionally
        # OPQ-rotated (codes encode (x - c) @ R; the scan rotates queries);
        # the pending tier stays dense bf16
        self.pq_m = int(pq_m) if pq_m else None
        self.pq_ksub = int(pq_ksub)
        self.pq_compute = pq_compute
        self.pq_codebooks: Optional[torch.Tensor] = None  # (M, ksub, dsub) f32
        self._pq_cb_store: Optional[torch.Tensor] = None  # compute-dtype copy
        self.pq_opq = bool(pq_opq)
        self.pq_rot: Optional[torch.Tensor] = None        # (D, D) f32
        if self.pq_m:
            if str(dtype).removeprefix("torch.") == "int8":
                raise ValueError("pq_m and int8 storage are exclusive")
            if self.dim % self.pq_m:
                raise ValueError(f"dim {self.dim} not divisible by pq_m={self.pq_m}")
            if pq_compute not in ("bf16", "f32"):
                raise ValueError("pq_compute must be 'bf16' or 'f32'")
            self.dtype_name, self.dtype = "uint8", torch.uint8  # list storage = codes
        else:
            if rerank:
                raise NotImplementedError(
                    f"the dense IVF shadow rerank is not ported yet ({_INT8_TIER})")
            self.dtype_name = _dtype_name(dtype)  # int8 raises, naming its tier
            self.dtype = _DTYPES[self.dtype_name]
        self.device = torch.device(device) if device is not None else default_device()
        self.train_iters = train_iters
        self.seed = seed
        self.recall_target = float(recall_target if recall_target is not None else 0.99)
        self.is_trained = False
        self.centroids: Optional[torch.Tensor] = None   # (nlist, D) f32
        self._cent_store: Optional[torch.Tensor] = None  # storage dtype
        self._cent_sq: Optional[torch.Tensor] = None
        # block-padded storage, ((nlist+1)*window, ...), sentinel block last
        self._sorted_vecs: Optional[torch.Tensor] = None
        self._sorted_sq: Optional[torch.Tensor] = None
        self._sorted_ids: Optional[torch.Tensor] = None
        self._offsets: Optional[torch.Tensor] = None
        self._lengths: Optional[torch.Tensor] = None
        self._window = 0
        self._n_built = 0
        self.ndeleted = 0
        self._pending = FlatIndex(dim, metric=metric,
                                  dtype="bfloat16" if self.pq_m else self.dtype_name,
                                  device=self.device)
        self._pending_rowids = np.zeros((0,), np.int32)
        self._pending_rowids_dev: Optional[torch.Tensor] = None
        self._n_spill = 0
        self._n_streamed = 0
        self._next_id = 0
        self.rebuild_threshold = 0.25
        self.rescue_rank_limit = 64
        self.window_quantile = 0.98
        self.use_fused = True
        self.balance = balance
        self.reassign_choices = int(reassign_choices)
        self.cap_factor = 2.0
        self.train_sample_per_list = 64
        self.union_cap = union_cap
        self.balance_weight = float(balance_weight)
        self._assign_bias: Optional[torch.Tensor] = None
        # PQ refine (FAISS IndexRefine analog): with pq_m, rerank keeps a
        # shadow of the full rows and re-scores the ADC scan's top
        # rerank_depth candidates (a deeper default pool: the ADC order is
        # what the refine repairs)
        self.rerank = bool(rerank)
        self.refine_dtype = refine_dtype
        self.rerank_depth = int(rerank_depth if rerank_depth is not None
                                else (64 if (self.pq_m and self.rerank) else 16))
        # the PQ refine shadow: COMPACT (n_rows, D) rows in any order, with
        # the (n_slots,) slot -> row map _shadow_pos (-1 = dead slot); a
        # block-padded D-wide shadow would cost slots / rows x its size
        self._sorted_shadow: Optional[torch.Tensor] = None
        self._sorted_shadow_scales: Optional[torch.Tensor] = None
        self._sorted_shadow_sq: Optional[torch.Tensor] = None
        self._shadow_pos: Optional[torch.Tensor] = None
        self.union_mode = union_mode
        self.query_chunk: Optional[int] = None
        # "pallas": the union-scan kernel on a CUDA index, its plain version
        # on a CPU one; "xla": the plain chunk body; "auto": the kernel
        # where eligible (ops/ivf_scan.resolve_fused_dispatch)
        self.backend = backend
        self.pallas_cap = int(pallas_cap)
        # 1: id-masked kernel (K2); 2: premasked norms + in-kernel top-k (K3)
        self.pallas_variant = int(pallas_variant)
        self.build_stats: dict = {}

    # ------------------------------------------------------------- building
    @property
    def ntotal(self) -> int:
        return self._next_id

    @property
    def nlive(self) -> int:
        """Rows that remain searchable (``ntotal`` minus tombstones)."""
        return self._n_built + self._pending.ntotal - self.ndeleted

    def remove_ids(self, ids) -> int:
        """Tombstone rows by original insertion id: a built row's block id
        becomes -1 (in place on the device), which every search path masks;
        a pending row is tombstoned in the flat tier and its rowid cleared.
        Returns the number of rows newly removed."""
        del_ids = np.unique(np.asarray(ids, np.int64).ravel())
        del_ids = del_ids[(del_ids >= 0) & (del_ids < self._next_id)]
        if not len(del_ids):
            return 0
        newly = 0
        if self._n_built:
            pos = np.nonzero(np.isin(self._sorted_ids.cpu().numpy(), del_ids))[0]
            if len(pos):
                self._sorted_ids[torch.as_tensor(pos, device=self.device)] = -1
                newly += int(len(pos))
        if self._pending.ntotal:
            ppos = np.nonzero(np.isin(self._pending_rowids, del_ids))[0]
            if len(ppos):
                newly += self._pending.remove_ids(ppos)
                self._pending_rowids[ppos] = -1
                self._pending_rowids_dev = None
        self.ndeleted += newly
        logger.debug("tombstoned %d rows (%d live)", newly, self.nlive)
        return newly

    def train(self, vectors) -> None:
        vecs = dist_ops.as_tensor(vectors, self.device, torch.float32)
        nlist = min(self.nlist, vecs.shape[0])
        if nlist < self.nlist:
            logger.warning("reducing nlist %d -> %d (few train vectors)", self.nlist, nlist)
            self.nlist = nlist
        max_train = self.train_sample_per_list * self.nlist
        if vecs.shape[0] > max_train:
            gen = torch.Generator(device=self.device).manual_seed(self.seed ^ 0x5EED)
            sel = torch.randperm(vecs.shape[0], generator=gen, device=self.device)
            train_vecs = vecs[sel[:max_train]]
        else:
            train_vecs = vecs
        kstats: dict = {}
        self.centroids, _, bias = train_kmeans(
            train_vecs, self.nlist, n_iters=self.train_iters, seed=self.seed,
            spherical=self.metric == "IP", balance_weight=self.balance_weight,
            return_bias=True, stats=kstats)
        self._assign_bias = bias if self.balance_weight else None
        t0 = time.perf_counter()
        if self.nlist >= 64:
            # relabel lists spatially so cell-sorted query chunks share lists
            order = torch.as_tensor(spatial_order(self.centroids, seed=self.seed),
                                    device=self.device)
            self.centroids = self.centroids[order]
            if self._assign_bias is not None:
                self._assign_bias = self._assign_bias[order]
        kstats["relabel_s"] = time.perf_counter() - t0
        self.build_stats["train"] = kstats
        self.is_trained = True

    # ----------------------------------------------------------------- PQ
    def _pq_encode_rows(self, rows_f32: torch.Tensor, lists: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Residual-encode rows against their lists' centroids (the sentinel
        list clamped to the last one); returns ((n, M) uint8 codes, (n,)
        float32 exact ||c + r̂||^2), chunked so no corpus-sized decode is
        made. Trains the codec on the residuals first if it has none."""
        if self.pq_codebooks is None:
            cl_all = lists.clamp_max(self.nlist - 1)
            self._train_pq_codec(rows_f32 - self.centroids[cl_all])
        codes_parts, sq_parts = [], []
        chunk = 131072
        for start in range(0, int(rows_f32.shape[0]), chunk):
            cents = self.centroids[lists[start:start + chunk].clamp_max(self.nlist - 1)]
            rc = rows_f32[start:start + chunk] - cents
            if self.pq_rot is not None:
                rc = rc @ self.pq_rot
            cc, _ = pq_ops.pq_encode(self.pq_codebooks, rc)
            rec = pq_ops.pq_decode(self.pq_codebooks, cc)
            if self.pq_rot is not None:
                rec = rec @ self.pq_rot.T  # back to the original basis
            sq_parts.append(dist_ops.sqnorms(rec + cents))
            codes_parts.append(cc)
        if not codes_parts:
            return (torch.zeros((0, self.pq_m), dtype=torch.uint8, device=self.device),
                    torch.zeros((0,), device=self.device))
        return torch.cat(codes_parts), torch.cat(sq_parts)

    def _train_pq_codec(self, resid_sample: torch.Tensor) -> None:
        """Train the residual codebooks (and the OPQ rotation with
        ``pq_opq``); drops the cached compute-dtype copy."""
        t0 = time.perf_counter()
        if self.pq_opq:
            self.pq_rot, cb = pq_ops.train_opq(resid_sample, self.pq_m, ksub=self.pq_ksub,
                                               n_iters=self.train_iters, seed=self.seed)
        else:
            cb = pq_ops.train_pq(resid_sample, self.pq_m, ksub=self.pq_ksub,
                                 n_iters=self.train_iters, seed=self.seed)
        self.pq_codebooks = cb
        self._pq_cb_store = None
        self.build_stats["pq_train_s"] = time.perf_counter() - t0

    def _refine_rows(self, rows_f32: torch.Tensor, exact_sq: torch.Tensor):
        """Refine-shadow rows: (int8 codes, scales, exact norms) for
        ``refine_dtype="int8"``, else (float32 / bf16 rows, None, norms).
        The norms ride along for persistence; the re-score uses each
        dequantized row's own norm."""
        if self.refine_dtype == "int8":
            codes, scales = quantize_rows(rows_f32)
            return codes, scales, exact_sq
        if self.refine_dtype == "float32":
            return rows_f32, None, exact_sq
        return rows_f32.to(torch.bfloat16), None, exact_sq

    def _pq_shadow(self):
        """The refine shadow as the fused scan takes it: (rows, scales |
        None, exact norms, slot -> row map), or None."""
        if self._sorted_shadow is None or not self.pq_m:
            return None
        return (self._sorted_shadow, self._sorted_shadow_scales,
                self._sorted_shadow_sq, self._shadow_pos)

    def _pq_cb_compute(self) -> torch.Tensor:
        """The codebooks in the scan's compute dtype (cached)."""
        if self._pq_cb_store is None:
            dt = torch.bfloat16 if self.pq_compute == "bf16" else torch.float32
            self._pq_cb_store = self.pq_codebooks.to(dt)
        return self._pq_cb_store

    def _cent_dtype(self) -> torch.dtype:
        """The coarse-scan centroid copy's dtype: the compute dtype under PQ,
        else the storage dtype."""
        if self.pq_m:
            return torch.bfloat16 if self.pq_compute == "bf16" else torch.float32
        return self.dtype

    def _rescue_exhausted(self, vecs_f32, spill_rows: np.ndarray,
                          assign_np: np.ndarray, cap: int) -> np.ndarray:
        """Place rows that exhausted every greedy choice into the nearest
        list with room, within ``rescue_rank_limit`` centroid ranks; the
        rest stay -1 and fall back to the pending tier."""
        rem = cap - np.bincount(assign_np[assign_np >= 0], minlength=self.nlist)
        sub = vecs_f32[torch.as_tensor(spill_rows, device=self.device)]
        dots = sub @ self.centroids.T
        if self.metric == "IP":
            d = -dots
        else:
            d = (self.centroids ** 2).sum(-1)[None, :] - 2.0 * dots
        d = d.cpu().numpy()
        max_rank = 0
        limit = min(self.rescue_rank_limit, self.nlist)
        for i, r in enumerate(spill_rows):
            for rank, lst in enumerate(np.argsort(d[i])[:limit]):
                if rem[lst] > 0:
                    assign_np[r] = int(lst)
                    rem[lst] -= 1
                    max_rank = max(max_rank, rank)
                    break
        self.build_stats["rescued_rows"] = int(len(spill_rows))
        self.build_stats["rescue_max_centroid_rank"] = int(max_rank)
        return assign_np

    def _reassign_cap(self, mean_len: float) -> int:
        """Capacity per list for balance='reassign': ``cap_factor`` x the
        mean length, rounded to 128."""
        return int(_round_up(max(128, int(mean_len * self.cap_factor)), 128))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, vectors, row_ids: Optional[np.ndarray] = None) -> None:
        """Train (if needed) and populate the block-padded inverted lists."""
        t_start = time.perf_counter()
        vecs_f32 = dist_ops.as_tensor(vectors, self.device, torch.float32)
        n = vecs_f32.shape[0]
        if not self.is_trained:
            self.train(vecs_f32)
        bstats = self.build_stats
        bstats["train_s"] = time.perf_counter() - t_start
        t0 = time.perf_counter()
        nlist = self.nlist
        if self.balance == "reassign":
            choices, cvals = assign_topk(vecs_f32, self.centroids, self.reassign_choices,
                                         metric=self.metric, bias=self._assign_bias)
            choices_np, pref = choices.cpu().numpy(), cvals.cpu().numpy()
            bstats["assign_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if self.metric == "IP":
                pref = -pref  # lexsort wants ascending preference
            cap = self._reassign_cap(n / nlist)
            assign_np, spill_rows = balanced_assignment(choices_np, pref, nlist, cap)
            if len(spill_rows):
                assign_np = self._rescue_exhausted(vecs_f32, spill_rows, assign_np, cap)
                still = spill_rows[assign_np[spill_rows] < 0]
                logger.info("balanced build: %d rows exhausted %d choices (cap %d); "
                            "rescued %d, %d spilled", len(spill_rows),
                            self.reassign_choices, cap, len(spill_rows) - len(still),
                            len(still))
            assignments = torch.as_tensor(np.where(assign_np >= 0, assign_np, nlist),
                                          device=self.device)
            lengths_np = np.bincount(assign_np[assign_np >= 0], minlength=nlist).astype(np.int64)
            window = int(_round_up(max(int(lengths_np.max()), 1), 128))
            bstats["balance_s"] = time.perf_counter() - t0
        else:
            assignments, _ = kmeans_assign(vecs_f32, self.centroids, metric=self.metric,
                                           bias=self._assign_bias)
            bstats["assign_s"] = time.perf_counter() - t0
            lengths_np = np.bincount(assignments.cpu().numpy(), minlength=nlist).astype(np.int64)
            max_len = max(int(lengths_np.max()), 1)
            # cap the probe window at a list-length quantile; longer lists
            # spill their overflow to the exact pending tier
            cap = int(_round_up(max(128, int(np.quantile(lengths_np, self.window_quantile))), 128))
            window = cap if cap < max_len else int(_round_up(max_len, 128))

        # ---- block-padded scatter: every list owns `window` slots
        t0 = time.perf_counter()
        dev = self.device
        order = torch.sort(assignments, stable=True).indices
        a_sorted = assignments[order]
        sorted_f32 = vecs_f32[order]
        if row_ids is None:
            sorted_ids = order.to(torch.int32)
        else:
            sorted_ids = dist_ops.as_tensor(row_ids, dev, torch.int32)[order]
        full_offsets = torch.as_tensor(
            np.r_[0, np.cumsum(np.r_[lengths_np, 0])], device=dev)  # (nlist+2,)
        rank = torch.arange(n, device=dev) - full_offsets[a_sorted]
        keep = (rank < window) & (a_sorted < nlist)
        n_slots = (nlist + 1) * window
        dest = torch.where(keep, a_sorted * window + rank,
                           torch.full_like(rank, nlist * window))
        src = torch.full((n_slots,), n, dtype=torch.long, device=dev)
        src[dest] = torch.arange(n, device=dev)
        src[nlist * window:] = n  # wipe the dump / sentinel block
        exact_sq = dist_ops.sqnorms(sorted_f32)  # exact, before any quantization
        self._sorted_shadow = self._sorted_shadow_scales = None
        self._sorted_shadow_sq = self._shadow_pos = None
        encode_s = 0.0
        if self.pq_m:
            self._sync()
            t_enc = time.perf_counter()
            sorted_codes, sorted_sq = self._pq_encode_rows(sorted_f32, a_sorted)
            if self.rerank:
                # compact shadow in sorted order + slot -> row map; spilled
                # rows keep entries no slot points to
                (self._sorted_shadow, self._sorted_shadow_scales,
                 self._sorted_shadow_sq) = self._refine_rows(sorted_f32, exact_sq)
                self._shadow_pos = torch.where(src < n, src, -1).to(torch.int32)
            self._sync()
            encode_s = time.perf_counter() - t_enc
            bstats["encode_s"] = encode_s
        else:
            sorted_codes, sorted_sq = sorted_f32.to(self.dtype), exact_sq
        zrow = sorted_codes.new_zeros((1, sorted_codes.shape[1]))
        self._sorted_vecs = torch.cat([sorted_codes, zrow])[src]
        self._sorted_sq = torch.cat([sorted_sq, sorted_sq.new_zeros(1)])[src]
        self._sorted_ids = torch.cat([sorted_ids, sorted_ids.new_full((1,), -1)])[src]
        self._sync()
        bstats["scatter_s"] = time.perf_counter() - t0 - encode_s

        # ---- spill rows (rank >= window, or the sentinel list) -> exact tier
        t0 = time.perf_counter()
        self._pending.reset()
        self._pending_rowids = np.zeros((0,), np.int32)
        self._pending_rowids_dev = None
        self._n_streamed = 0
        keep_np = keep.cpu().numpy()
        n_spill = int((~keep_np).sum())
        self._n_spill = n_spill
        if n_spill:
            pos = torch.as_tensor(np.nonzero(~keep_np)[0], device=dev)
            self._pending.add(sorted_f32[pos])
            self._pending_rowids = sorted_ids[pos].cpu().numpy()
            if self.balance != "reassign":
                logger.info("capped IVF window at %d (max list %d): %d rows spilled "
                            "to the exact tier", window, int(lengths_np.max()), n_spill)
        self._offsets = torch.arange(nlist, dtype=torch.int32, device=dev) * window
        self._lengths = torch.as_tensor(np.minimum(lengths_np, window), dtype=torch.int32,
                                        device=dev)
        self._cent_store = self.centroids.to(self._cent_dtype())
        self._cent_sq = dist_ops.sqnorms(self.centroids)
        self._window = window
        self._n_built = n - n_spill
        self._next_id = n if row_ids is None else (
            int(np.max(row_ids)) + 1 if len(row_ids) else 0)
        self.ndeleted = 0  # a (re)build installs live rows only
        bstats["finalize_s"] = time.perf_counter() - t0
        bstats["total_s"] = time.perf_counter() - t_start
        logger.info("built IVF: n=%d nlist=%d window=%d spill=%d", n, nlist, window, n_spill)

    def build_chunked(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "build_chunked (the out-of-memory IVF-PQ build) is not ported yet")

    def add(self, vectors) -> None:
        """Streaming add into the exact pending tier; the first add builds,
        and the tier is merged once it outgrows ``rebuild_threshold`` of the
        built tier."""
        vecs = dist_ops.as_tensor(vectors, self.device, torch.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if not self.is_trained:
            self.build(vecs)
            return
        n_new = vecs.shape[0]
        self._pending.add(vecs)
        self._pending_rowids = np.concatenate([
            self._pending_rowids,
            np.arange(self._next_id, self._next_id + n_new, dtype=np.int32)])
        self._pending_rowids_dev = None
        self._next_id += n_new
        self._n_streamed += n_new
        if self._n_streamed > self.rebuild_threshold * max(self._n_built, 1):
            self.rebuild()

    def rebuild(self) -> None:
        """Merge the pending tier into the lists (centroids kept); surviving
        rows keep their ids."""
        if self._pending.ntotal == 0 and not self.ndeleted:
            return
        all_vecs, all_ids = self.vectors(return_ids=True)
        logger.info("rebuilding IVF with %d vectors", len(all_vecs))
        self.build(all_vecs, row_ids=all_ids)

    # -------------------------------------------------------------- search
    def _pending_dev(self):
        """Spill / streaming tier as fused-search inputs: (codes, None,
        sqnorms, global row ids padded to capacity with -1)."""
        if self._pending_rowids_dev is None or (
                self._pending_rowids_dev.shape[0] != self._pending._capacity):
            ids = np.full((self._pending._capacity,), -1, np.int32)
            ids[:len(self._pending_rowids)] = self._pending_rowids
            self._pending_rowids_dev = torch.as_tensor(ids, device=self.device)
        return (self._pending._buf, None, self._pending._sq, self._pending_rowids_dev)

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probe-limited top-k: (values, ids), (Q, k), on the index's device.
        ``filter_mask``: optional (ntotal,) bool by insertion id, True =
        searchable; it routes the search to the plain chunk body."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q = dist_ops.as_tensor(queries, self.device, torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        if self.ntotal == 0:
            fill = float("inf") if self.metric == "L2" else float("-inf")
            return (torch.full((nq, k), fill, device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int32, device=self.device))
        filt = None
        if filter_mask is not None:
            filt = dist_ops.as_tensor(filter_mask, self.device, torch.bool)
            if filt.shape[0] != self.ntotal:
                raise ValueError(f"filter_mask has {filt.shape[0]} entries, "
                                 f"index has {self.ntotal} ids")
        if self._n_built == 0:
            rowids = self._pending_dev()[3]
            pfilt = None
            if filt is not None:
                pr = rowids[:self._pending.ntotal]
                pfilt = (pr >= 0) & filt[pr.clamp_min(0).long()]
            vals, pidx = self._pending.search(q, k, filter_mask=pfilt)
            pidx = torch.where(pidx >= 0, rowids[pidx.clamp_min(0).long()],
                               torch.full_like(pidx, -1))
            return vals, pidx
        if not self.use_fused:
            raise NotImplementedError(
                "the per-query windowed IVF search is not ported; "
                "probe_scan_math is kept as a test oracle only")
        spill = self._pending_dev() if self._pending.ntotal else None
        backend = self.backend
        if (filt is not None or self.pq_m) and backend == "pallas":
            # the union scan has no filter operand and no PQ stage; PQ keeps
            # its decode kernel inside the plain chunk body
            backend = "xla"
        return fused_ivf_search(
            q, self._cent_store, self._cent_sq, self._sorted_vecs, None,
            self._sorted_sq, self._sorted_ids, spill, None, filt,
            self._pq_cb_compute() if self.pq_m else None,
            bool(self.pq_m) and self.backend != "xla", self._pq_shadow(), self.pq_rot,
            k=k, nprobe=nprobe, window=self._window, metric=self.metric,
            recall_target=self.recall_target, union_cap=self.union_cap,
            rerank_depth=self.rerank_depth, qc=self.query_chunk,
            union_mode=self._resolved_union_mode(), backend=backend,
            pallas_cap=self.pallas_cap, pallas_variant=self.pallas_variant)

    def _resolved_union_mode(self) -> str:
        """'auto' = chunkmax past 2048 lists, minrank below."""
        if self.union_mode != "auto":
            return self.union_mode
        return "chunkmax" if self.nlist > 2048 else "minrank"

    def resolved_dispatch(self, nq: int, k: int = 10) -> dict:
        """The dispatch a defaults call to ``search`` on this built index
        uses (``ops.ivf_scan.resolve_fused_dispatch`` plus the index's own
        knobs)."""
        if self._sorted_vecs is None:
            raise ValueError("resolved_dispatch needs a built index")
        backend = self.backend
        if self.pq_m and backend == "pallas":
            backend = "xla"
        out = resolve_fused_dispatch(
            nq=nq, dim=self.dim, nlist=self.nlist, window=self._window,
            code_bytes=self._sorted_vecs.element_size(), quantized=False,
            has_shadow=False, has_pq=bool(self.pq_m), has_filter=False,
            nprobe=min(self.nprobe, self.nlist), union_cap=self.union_cap,
            qc=self.query_chunk, backend=backend,
            platform=self._sorted_vecs.device.type)
        out.update({
            "union_mode": self._resolved_union_mode(),
            "pallas_variant": self.pallas_variant,
            "pallas_cap": self.pallas_cap,
            "rerank_depth": self.rerank_depth,
            "recall_target": self.recall_target,
            "window": self._window,
            "k": k,
        })
        return out

    # ------------------------------------------------------------- manage
    def reset(self) -> None:
        """Drop every row and the coarse quantizer; PQ codebooks are kept."""
        self.is_trained = False
        self.centroids = self._cent_store = self._cent_sq = None
        self._sorted_vecs = self._sorted_sq = self._sorted_ids = None
        self._sorted_shadow = self._sorted_shadow_scales = None
        self._sorted_shadow_sq = self._shadow_pos = None
        self._offsets = self._lengths = None
        self._window = self._n_built = self._next_id = 0
        self._n_spill = self._n_streamed = 0
        self.ndeleted = 0
        self._pending_rowids = np.zeros((0,), np.int32)
        self._pending_rowids_dev = None
        self._pending.reset()

    def _live_mask(self) -> np.ndarray:
        return self._sorted_ids.cpu().numpy() >= 0

    def _built_rows(self, pos: torch.Tensor) -> torch.Tensor:
        """float32 rows of block slots ``pos``: the stored rows, or under PQ
        the refine shadow (the better copy) or else centroid + decoded
        residual (un-rotated from the OPQ basis)."""
        if not self.pq_m:
            return self._sorted_vecs[pos].float()
        if self._sorted_shadow is not None:
            sp = self._shadow_pos[pos].long()
            if self._sorted_shadow_scales is not None:
                return dequantize(self._sorted_shadow[sp], self._sorted_shadow_scales[sp])
            return self._sorted_shadow[sp].float()
        resid = pq_ops.pq_decode(self.pq_codebooks, self._sorted_vecs[pos])
        if self.pq_rot is not None:
            resid = resid @ self.pq_rot.T
        return resid + self.centroids[pos // self._window]

    def vectors(self, return_ids: bool = False):
        """Live vectors in original insertion order (float32 host copies;
        tombstones excluded; PQ rows reconstructed), and with ``return_ids``
        their ids."""
        all_vecs, all_ids = [], []
        if self._n_built:
            live = self._live_mask()
            pos = torch.as_tensor(np.nonzero(live)[0], device=self.device)
            all_vecs.append(self._built_rows(pos).cpu().numpy())
            all_ids.append(self._sorted_ids.cpu().numpy()[live])
        if self._pending.ntotal:
            plive = self._pending_rowids >= 0
            all_vecs.append(self._pending.vectors()[plive])
            all_ids.append(self._pending_rowids[plive])
        if not all_vecs:
            empty = np.zeros((0, self.dim), np.float32)
            return (empty, np.zeros((0,), np.int32)) if return_ids else empty
        vecs = np.concatenate(all_vecs)
        ids = np.concatenate(all_ids)
        order = np.argsort(ids, kind="stable")
        if return_ids:
            return vecs[order], ids[order].astype(np.int32)
        return vecs[order]

    # ---------------------------------------------------------------- io
    def state_dict(self) -> dict:
        """Exact state in the "padded_v3" format: live block rows in list
        order + per-list lengths (reload re-scatters them), the pending tier's
        live rows, the centroids; under PQ the codebooks, the OPQ rotation
        and the refine shadow's rows in the same block order."""
        state = {
            "kind": "ivf",
            "format": "padded_v3",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "window_quantile": self.window_quantile,
            "balance": self.balance,
            "window": self._window,
            "next_id": self._next_id,
            "rerank_depth": self.rerank_depth,
            "n_streamed": self._n_streamed,
            "n_spill": self._n_spill,
            "centroids": self.centroids.cpu().numpy() if self.centroids is not None
            else np.zeros((0, self.dim), np.float32),
            "assign_bias": self._assign_bias.cpu().numpy()
            if self._assign_bias is not None else np.zeros((0,), np.float32),
        }
        if self.pq_m:
            state.update({
                "pq_m": self.pq_m,
                "pq_ksub": self.pq_ksub,
                "pq_compute": self.pq_compute,
                "pq_codebooks": self.pq_codebooks.cpu().numpy()
                if self.pq_codebooks is not None
                else np.zeros((self.pq_m, 0, self.dim // self.pq_m), np.float32),
            })
            if self.pq_rot is not None:
                state["pq_rot"] = self.pq_rot.cpu().numpy()
        if self._n_built:
            live = self._live_mask()
            pos = torch.as_tensor(np.nonzero(live)[0], device=self.device)
            state.update({
                "codes": codec.to_host(self._sorted_vecs[pos]),
                "sqnorms": self._sorted_sq[pos].cpu().numpy(),
                "sorted_ids": self._sorted_ids[pos].cpu().numpy(),
                "lengths": live[: self.nlist * self._window]
                .reshape(self.nlist, self._window).sum(1).astype(np.int64),
            })
            if self._sorted_shadow is not None:
                sh = self._shadow_pos[pos].long()
                state["shadow"] = codec.to_host(self._sorted_shadow[sh])
                if self._sorted_shadow_scales is not None:
                    state["shadow_scales"] = self._sorted_shadow_scales[sh].cpu().numpy()
                if self._sorted_shadow_sq is not None:
                    state["shadow_sq"] = self._sorted_shadow_sq[sh].cpu().numpy()
                state["refine_dtype"] = self.refine_dtype
        if self._pending.ntotal:
            p = self._pending
            plive = self._pending_rowids >= 0
            psel = torch.as_tensor(np.nonzero(plive)[0], device=self.device)
            state.update({
                "pending_codes": codec.to_host(p._buf[psel]),
                "pending_sq": p._sq[psel].cpu().numpy(),
                "pending_rowids": self._pending_rowids[plive],
            })
        return state

    def _install_blocks(self, codes, sq, ids, lengths_np: np.ndarray, shadow=None,
                        shadow_scales=None, shadow_sq=None) -> None:
        """Scatter compact per-list rows into the block-padded layout; a PQ
        refine shadow stays compact, with its slot -> row map."""
        nlist, window, dev = self.nlist, self._window, self.device
        n_live = int(codes.shape[0])
        listid = np.repeat(np.arange(nlist), lengths_np)
        rank = np.arange(n_live) - np.repeat(np.r_[0, np.cumsum(lengths_np)[:-1]], lengths_np)
        dest = torch.as_tensor(listid * window + rank, device=dev)
        src = torch.full(((nlist + 1) * window,), n_live, dtype=torch.long, device=dev)
        src[dest] = torch.arange(n_live, device=dev)
        codes, sq, ids = (t.to(dev) for t in (codes, sq, ids))
        self._sorted_vecs = torch.cat([codes, codes.new_zeros((1, codes.shape[1]))])[src]
        self._sorted_sq = torch.cat([sq, sq.new_zeros(1)])[src]
        self._sorted_ids = torch.cat([ids, ids.new_full((1,), -1)])[src]
        if shadow is not None:
            self._sorted_shadow = shadow.to(dev)
            self._sorted_shadow_scales = (shadow_scales.to(dev)
                                          if shadow_scales is not None else None)
            self._sorted_shadow_sq = shadow_sq.to(dev) if shadow_sq is not None else None
            self._shadow_pos = torch.where(src < n_live, src, -1).to(torch.int32)
        self._offsets = torch.arange(nlist, dtype=torch.int32, device=dev) * window
        self._lengths = torch.as_tensor(lengths_np, dtype=torch.int32, device=dev)
        self._cent_store = self.centroids.to(self._cent_dtype())
        self._cent_sq = dist_ops.sqnorms(self.centroids)
        self._n_built = n_live

    @classmethod
    def from_state_dict(cls, state: dict, **kwargs) -> "IVFFlatIndex":
        def item(v):
            v = np.asarray(v)
            return v.item() if v.ndim == 0 else v

        pq_kwargs = {}
        if "pq_m" in state:
            pq_kwargs = {"pq_m": int(item(state["pq_m"])),
                         "pq_ksub": int(item(state["pq_ksub"])),
                         "pq_compute": str(item(state["pq_compute"]))}
        elif "shadow" in state:
            raise NotImplementedError(
                f"dense IVF shadow-rerank indexes are not ported yet ({_INT8_TIER})")
        # under PQ the list dtype is re-derived (uint8 codes)
        dtype = "bfloat16" if pq_kwargs else str(item(state["dtype"]))
        idx = cls(dim=int(item(state["dim"])), nlist=int(item(state["nlist"])),
                  metric=str(item(state["metric"])), nprobe=int(item(state["nprobe"])),
                  dtype=dtype, **pq_kwargs, **kwargs)
        cb = np.asarray(state.get("pq_codebooks", np.zeros(0)))
        if cb.size:
            idx.pq_codebooks = torch.tensor(cb, dtype=torch.float32, device=idx.device)
        if "pq_rot" in state:
            idx.pq_opq = True
            idx.pq_rot = torch.tensor(np.asarray(state["pq_rot"]), dtype=torch.float32,
                                      device=idx.device)
        if "window_quantile" in state:
            idx.window_quantile = float(item(state["window_quantile"]))
        if "rerank_depth" in state:
            idx.rerank_depth = int(item(state["rerank_depth"]))
        if "balance" in state:
            idx.balance = str(item(state["balance"]))
        centroids = np.asarray(state["centroids"])
        if centroids.size:
            idx.centroids = torch.tensor(centroids, dtype=torch.float32, device=idx.device)
            idx.is_trained = True
        bias = np.asarray(state.get("assign_bias", np.zeros(0)))
        if bias.size:
            idx._assign_bias = torch.tensor(bias, dtype=torch.float32, device=idx.device)

        fmt = str(item(state.get("format", "")))
        if fmt not in ("padded_v3", "sorted_v2"):
            vectors = np.asarray(state["vectors"])  # legacy: rebuild
            if len(vectors):
                idx.build(vectors)
            return idx
        idx._window = int(item(state["window"]))
        idx._next_id = int(item(state["next_id"]))
        idx._n_streamed = int(item(state["n_streamed"]))
        idx._n_spill = int(item(state.get("n_spill", 0)))
        if "codes" in state:
            codes = codec.from_host(np.asarray(state["codes"]), idx.dtype)
            sq = torch.tensor(np.asarray(state["sqnorms"]), dtype=torch.float32)
            ids = torch.tensor(np.asarray(state["sorted_ids"]), dtype=torch.int32)
            shadow = shadow_scales = shadow_sq = None
            if "shadow" in state:
                sh_np = np.asarray(state["shadow"])
                # int8 and float32 shadows save as their values, bf16 as bits
                shadow = codec.from_host(sh_np, _SHADOW_DTYPES.get(sh_np.dtype, torch.bfloat16))
                if "shadow_scales" in state:
                    shadow_scales = torch.tensor(np.asarray(state["shadow_scales"]),
                                                 dtype=torch.float32)
                if "shadow_sq" in state:
                    shadow_sq = torch.tensor(np.asarray(state["shadow_sq"]),
                                             dtype=torch.float32)
                if "refine_dtype" in state:
                    idx.refine_dtype = str(item(state["refine_dtype"]))
            idx.rerank = shadow is not None
            lengths_np = np.asarray(state["lengths"], np.int64)
            if fmt == "sorted_v2":
                # legacy contiguous layout: list l's live rows are the first
                # lengths[l] at offsets[l]; the shadow rows run beside them
                offsets_np = np.asarray(state["offsets"], np.int64)
                sel = torch.as_tensor(np.concatenate([
                    np.arange(off, off + ln) for off, ln in zip(offsets_np, lengths_np)
                ]).astype(np.int64) if lengths_np.sum() else np.zeros(0, np.int64))
                codes, sq, ids = codes[sel], sq[sel], ids[sel]
                shadow, shadow_scales, shadow_sq = (
                    t[sel] if t is not None else None
                    for t in (shadow, shadow_scales, shadow_sq))
            idx._install_blocks(codes, sq, ids, lengths_np, shadow=shadow,
                                shadow_scales=shadow_scales, shadow_sq=shadow_sq)
        if "pending_codes" in state:
            idx._pending = FlatIndex.from_state_dict(
                {"dim": idx.dim, "metric": idx.metric, "dtype": idx._pending.dtype_name,
                 "vectors": np.asarray(state["pending_codes"])}, device=idx.device)
            idx._pending_rowids = np.asarray(state["pending_rowids"], np.int32)
            idx._pending_rowids_dev = None
        return idx
