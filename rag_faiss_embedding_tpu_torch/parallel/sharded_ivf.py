"""IVF sharded over a device mesh: shared centroids, per-shard inverted lists.

Counterpart of ``rag_faiss_embedding_tpu/parallel/sharded_ivf.py`` (BASELINE.md
configs #3 and #4 together), with its layout, arguments and file format:

- centroids are trained once on the whole corpus (spherical k-means for IP,
  spatially relabeled from 64 lists) and copied to every shard;
- each position of the ``db`` mesh axis owns a contiguous range of the
  rows and holds its own BLOCK-PADDED lists, every list ``window`` slots
  wide, dead slots with id -1: the single-device IVF layout, one per shard,
  as one tensor per shard on its device. The layout is computed on the
  first db device (assignment, per-shard stable sort, slot scatter) and each
  shard's blocks are gathered and moved to its device;
- the window is capped at a list-length quantile (0.98); a shard's rows past
  the cap go to its spill tier, scanned exactly;
- storage is float32, bfloat16 or int8 (per-row scales, exact float32
  norms), or IVF-PQ (``pq_m``: residual codes and exact ||c + r̂||^2); the
  spill and pending tiers of int8 and PQ indexes stay bfloat16;
- streaming adds are staged on the host and copied to the shards
  round-robin as a pending tier scanned exactly; ``rebuild`` folds them in
  past a quarter of the built rows;
- search: on each shard the single-device fused search
  (``ops/ivf_scan.fused_ivf_search_math``) over its lists, with JAX's
  backend choice: the union-scan kernel (K2, ``csrc/union_scan.cu``) on
  eligible full-precision storage with no filter, the PQ decode kernel (K4,
  ``csrc/pq_decode.cu``) inside the PQ chunk body, the plain chunk body
  otherwise (on a CPU shard the kernels' plain versions); then the spill
  and pending tiers by an exact scan (``_tier_scan``, plain torch, as JAX's
  is XLA code), a merge on the shard, and a merge of every shard's
  (k values, k global ids) on the first db device (``parallel/sharded``).

Row ids are global insertion positions, so ``VectorStore``'s position ->
doc-id mapping works unchanged. ``state_dict`` writes JAX's
"sharded_padded_v1" arrays in JAX's order (device-major, list, rank), so
either package loads the other's file, onto a mesh of the same or another
size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.mesh import Mesh, make_mesh, replicated
from ..index import codec
from ..index.flat import _DTYPES, _dtype_name, _round_up
from ..ops import distance as dist_ops
from ..ops import pq as pq_ops
from ..ops.ivf_scan import default_union_cap, fused_ivf_search_math, pick_query_chunk
from ..ops.kmeans import assign as kmeans_assign, spatial_order, train_kmeans
from ..ops.quantize import dequantize, quantize_rows
from ..ops.union_scan import kernel_eligible
from .sharded import _fill, merge_shards, pad_to_k

logger = get_logger(__name__)


def _tier_scan(q, vecs, sq, ids, count, k, metric="L2", filt=None):
    """Exact scan over one shard's tier (spill / pending): (values, global
    ids), invalid slots (inf | -inf, -1). ``filt`` ((next_id,) bool, True =
    searchable) masks rows before selection."""
    dead = None
    if filt is not None:
        dead = ~((ids >= 0) & filt[ids.clamp_min(0).long()])
    vals, idx = dist_ops.exact_search(q, vecs, k, metric=metric, db_sq=sq,
                                      n_valid=int(count), chunk_size=max(1, vecs.shape[0]),
                                      dead=dead)
    gids = torch.where(idx >= 0, ids[idx.clamp_min(0).long()], torch.full_like(idx, -1))
    vals = torch.where(gids >= 0, vals, torch.full_like(vals, _fill(metric)))
    return vals, gids


class ShardedIVFIndex:
    """IVF sharded over a device mesh (build once, stream, query many)."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        nlist: int = 1024,
        nprobe: int = 8,
        metric: str = "L2",
        dtype: str | torch.dtype = "float32",
        db_axis: str = "db",
        train_iters: int = 20,
        seed: int = 0,
        union_cap: Optional[int] = None,
        backend: str = "auto",
        pq_m: Optional[int] = None,
        pq_ksub: int = 256,
        pq_compute: str = "bf16",
    ):
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        if backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"bad backend {backend!r}")
        self.dim = int(dim)
        self.mesh = mesh
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.metric = metric
        # IVF-PQ: the lists hold M-byte residual codes (index/ivf.py's design)
        self.pq_m = int(pq_m) if pq_m else None
        self.pq_ksub = int(pq_ksub)
        self.pq_compute = pq_compute
        self.pq_codebooks: Optional[torch.Tensor] = None  # (M, ksub, dsub) f32
        self._pq_cb_cache: Optional[list] = None          # per shard, compute dtype
        if self.pq_m:
            if str(dtype).removeprefix("torch.") == "int8":
                raise ValueError("pq_m and int8 storage are exclusive")
            if self.dim % self.pq_m:
                raise ValueError(f"dim {self.dim} not divisible by pq_m={self.pq_m}")
            if pq_compute not in ("bf16", "f32"):
                raise ValueError("pq_compute must be 'bf16' or 'f32'")
            self.dtype_name, self.dtype = "uint8", torch.uint8
        else:
            self.dtype_name = _dtype_name(dtype)
            self.dtype = _DTYPES[self.dtype_name]
        self.quantized = self.dtype == torch.int8
        # the spill / pending tiers are small; int8 and PQ keep them in bf16
        self._tier_dtype = torch.bfloat16 if (self.quantized or self.pq_m) else self.dtype
        self.db_axis = db_axis
        self.n_dev = mesh.shape[db_axis]
        self.devices = mesh.axis_devices(db_axis)
        self.device = self.devices[0]  # builds run and results land here
        self.train_iters = train_iters
        self.seed = seed
        self.union_cap = union_cap
        # "auto": the union-scan kernel where eligible (a CUDA mesh,
        # full-precision storage, 128-aligned shapes); "pallas" asks for it
        # (its plain version on a CPU mesh); "xla": the plain chunk body
        self.backend = backend
        self.recall_target = 0.995 if self.quantized else 0.99
        self.window_quantile = 0.98
        self.rebuild_threshold = 0.25
        self.centroids: Optional[torch.Tensor] = None
        self._replicated = replicated(mesh)
        self._clear_state()

    def _clear_state(self) -> None:
        # per shard: block-padded lists, every list `window` slots
        self._vecs = None          # [((nlist+1)*window, D | M)] storage
        self._scales = None        # [((nlist+1)*window,)] f32 (int8)
        self._sq = None            # [((nlist+1)*window,)] f32
        self._ids = None           # [((nlist+1)*window,)] int32, -1 dead
        self._cent_store = None    # [(nlist, D)] centroids per shard
        self._cent_sq = None
        self._spill = None         # None | ([vecs], [sq], [ids], [count])
        self._window = 0
        self._n_built = 0
        self._next_id = 0
        self.ndeleted = 0
        # streaming pending tier: staged on the host, copied round-robin
        self._stream_vecs = np.zeros((0, self.dim), np.float32)
        self._stream_ids = np.zeros((0,), np.int32)
        self._pending_dev = None   # None | ([vecs], [sq], [ids], [count])

    @property
    def ntotal(self) -> int:
        return self._next_id

    def _per_shard(self, t: torch.Tensor) -> list:
        """``t`` copied to every shard's device (views where they share one)."""
        return self._replicated.put_along(t, self.db_axis)

    # ------------------------------------------------------------- building
    def _pq_encode_rows(self, rows_f32: torch.Tensor, lists: torch.Tensor):
        """Residual-encode rows against their lists' centroids: ((n, M)
        uint8, (n,) exact ||c + r̂||^2), chunked. Trains the codebooks on
        the residuals first if there are none."""
        cents = self.centroids[lists]
        resid = rows_f32 - cents
        if self.pq_codebooks is None:
            self.pq_codebooks = pq_ops.train_pq(resid, self.pq_m, ksub=self.pq_ksub,
                                                n_iters=self.train_iters, seed=self.seed)
            self._pq_cb_cache = None
        codes_parts, sq_parts = [], []
        chunk = 131072
        for start in range(0, int(rows_f32.shape[0]), chunk):
            cc, _ = pq_ops.pq_encode(self.pq_codebooks, resid[start:start + chunk])
            rec = pq_ops.pq_decode(self.pq_codebooks, cc)
            sq_parts.append(dist_ops.sqnorms(rec + cents[start:start + chunk]))
            codes_parts.append(cc)
        return torch.cat(codes_parts), torch.cat(sq_parts)

    def _pq_operands(self):
        """(codebooks in the compute dtype per shard, decode through the
        kernel wrapper), or (None, False) without PQ storage. The wrapper
        launches K4 on a CUDA shard and runs its plain version on a CPU one,
        bit for bit the same decode, so "auto" and "pallas" both take it."""
        if not self.pq_m:
            return None, False
        if self._pq_cb_cache is None:
            dt = torch.bfloat16 if self.pq_compute == "bf16" else torch.float32
            self._pq_cb_cache = self._per_shard(self.pq_codebooks.to(dt))
        return self._pq_cb_cache, self.backend != "xla"

    def _cent_dtype(self) -> torch.dtype:
        if self.pq_m and self.pq_compute == "f32":
            return torch.float32  # the coarse dots feed the residual shift
        return self._tier_dtype

    def _install_centroids(self) -> None:
        self._cent_store = self._per_shard(self.centroids.to(self._cent_dtype()))
        self._cent_sq = self._per_shard(dist_ops.sqnorms(self.centroids))

    def build(self, vectors, row_ids: Optional[np.ndarray] = None) -> None:
        """Train the centroids on the whole corpus (unless set), then build
        every shard's lists on the device.

        ``row_ids`` gives the rows explicit (possibly sparse) global ids,
        as ``rebuild()`` does so that surviving rows keep theirs after
        ``remove_ids``; by default row i has id i."""
        dev, n_dev = self.device, self.n_dev
        vecs = dist_ops.as_tensor(vectors, dev, torch.float32)
        n, d = int(vecs.shape[0]), self.dim
        nlist = min(self.nlist, max(1, n // n_dev))
        if nlist != self.nlist:
            logger.warning("reducing nlist %d -> %d", self.nlist, nlist)
            self.nlist = nlist
        if self.centroids is None or self.centroids.shape[0] != self.nlist:
            cents, _ = train_kmeans(vecs, self.nlist, n_iters=self.train_iters,
                                    seed=self.seed, spherical=self.metric == "IP")
            if self.nlist >= 64:
                # spatial relabeling: the fused search's chunk locality needs
                # id-adjacent lists to be spatially adjacent
                cents = cents[torch.as_tensor(spatial_order(cents, seed=self.seed), device=dev)]
            self.centroids = cents
        self.centroids = self.centroids.to(device=dev, dtype=torch.float32)

        # ---- per-shard layout: one stable sort over (n_dev, per)
        assigns, _ = kmeans_assign(vecs, self.centroids, metric=self.metric)
        per = -(-n // n_dev)
        n_pad = per * n_dev
        a2 = torch.cat([assigns.long(), assigns.new_full((n_pad - n,), nlist).long()]
                       ).view(n_dev, per)
        order = torch.sort(a2, dim=1, stable=True).indices   # sentinel pads sort last
        sorted_a = a2.gather(1, order)
        valid = sorted_a < nlist
        lengths = torch.zeros((n_dev, nlist + 1), dtype=torch.long, device=dev)
        lengths.scatter_add_(1, sorted_a, torch.ones_like(sorted_a))
        lengths = lengths[:, :nlist]
        offsets = torch.cat([lengths.new_zeros((n_dev, 1)), lengths.cumsum(1)[:, :-1]], 1)
        vecs_pad = torch.cat([vecs, vecs.new_zeros((n_pad - n, d))]).view(n_dev, per, d)
        sorted_vecs = vecs_pad.gather(1, order[..., None].expand(-1, -1, d))
        del vecs, vecs_pad
        sorted_sq = (sorted_vecs * sorted_vecs).sum(-1)
        if row_ids is None:
            base = (torch.arange(n_dev, device=dev) * per)[:, None]
            gids = torch.where(valid, base + order, -1).to(torch.int32)
        else:
            rid = torch.cat([dist_ops.as_tensor(row_ids, dev, torch.long),
                             torch.full((n_pad - n,), -1, dtype=torch.long, device=dev)])
            gids = torch.where(valid, rid.view(n_dev, per).gather(1, order), -1
                               ).to(torch.int32)

        # ---- window capped at the list-length quantile
        lengths_np = lengths.cpu().numpy()
        max_len = max(int(lengths_np.max()), 1)
        cap = int(_round_up(max(128, int(np.quantile(lengths_np, self.window_quantile))), 128))
        window = cap if cap < max_len else int(_round_up(max_len, 128))

        # rank of each row within its shard-local list
        rank = torch.arange(per, device=dev)[None, :] - offsets.gather(
            1, sorted_a.clamp_max(nlist - 1))
        keep = (valid & (rank < window)).reshape(-1)

        scales = None
        if self.pq_m:
            codes, rec_sq = self._pq_encode_rows(sorted_vecs.reshape(-1, d),
                                                 sorted_a.clamp_max(nlist - 1).reshape(-1))
        elif self.quantized:
            codes, scales = quantize_rows(sorted_vecs.reshape(-1, d))
        else:
            codes = sorted_vecs.to(self.dtype).reshape(-1, d)

        # ---- block-padded lists: every row inside the window into its
        # (shard, list, rank) slot; PQ lists rank by the ADC identity:
        # reconstruction norms (the spill tier below keeps true norms: it
        # stays dense)
        shard_of = torch.arange(n_dev, device=dev).repeat_interleave(per)
        self._install_rows(codes[keep], (rec_sq if self.pq_m else sorted_sq.reshape(-1))[keep],
                           gids.reshape(-1)[keep].cpu().numpy(),
                           scales[keep] if scales is not None else None,
                           shard_of[keep].cpu().numpy(),
                           sorted_a.reshape(-1)[keep].cpu().numpy(), window)
        del codes, scales

        # ---- rows past the window -> the shard's exact spill tier
        self._spill = None
        spill_mask = valid & (rank >= window)
        s_counts = spill_mask.sum(1).cpu().numpy()
        n_spill = int(s_counts.sum())
        if n_spill:
            s_pad = min(per, _round_up(int(s_counts.max()), 128))
            # spill rows first (stable), then a uniform prefix
            sel = torch.sort((~spill_mask).to(torch.uint8), dim=1, stable=True
                             ).indices[:, :s_pad]
            sp_vecs = sorted_vecs.gather(1, sel[..., None].expand(-1, -1, d))
            sp_sq = sorted_sq.gather(1, sel)
            sp_ids = torch.where(spill_mask.gather(1, sel), gids.gather(1, sel), -1
                                 ).to(torch.int32)
            self._spill = (
                [sp_vecs[j].to(self._tier_dtype).to(dv) for j, dv in enumerate(self.devices)],
                [sp_sq[j].to(dv) for j, dv in enumerate(self.devices)],
                [sp_ids[j].to(dv) for j, dv in enumerate(self.devices)],
                [int(c) for c in s_counts],
            )
            logger.info("capped sharded-IVF window at %d (max list %d): %d rows spilled "
                        "to per-shard exact tiers", window, max_len, n_spill)

        self._install_centroids()
        self._window = window
        self._n_built = n
        self._next_id = n if row_ids is None else (
            int(np.max(row_ids)) + 1 if len(row_ids) else 0)
        self.ndeleted = 0  # a (re)build installs live rows only
        self._stream_vecs = np.zeros((0, self.dim), np.float32)
        self._stream_ids = np.zeros((0,), np.int32)
        self._pending_dev = None
        logger.info("built sharded IVF: n=%d over %d shards, nlist=%d window=%d",
                    n, n_dev, self.nlist, window)

    # ------------------------------------------------------------ streaming
    def add(self, vectors) -> None:
        """Streaming add: staged on the host, copied round-robin to the
        shards' exact pending tier; the first add builds, and the tier is
        folded in past ``rebuild_threshold`` of the built rows."""
        vecs = dist_ops.as_tensor(vectors, dtype=torch.float32).cpu().numpy()
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if self._n_built == 0:
            self.build(vecs)
            return
        n_new = len(vecs)
        ids = np.arange(self._next_id, self._next_id + n_new, dtype=np.int32)
        self._stream_vecs = np.concatenate([self._stream_vecs, vecs])
        self._stream_ids = np.concatenate([self._stream_ids, ids])
        self._next_id += n_new
        self._pending_dev = None  # the shards' copy is stale
        if len(self._stream_ids) > self.rebuild_threshold * self._n_built:
            self.rebuild()

    @property
    def nlive(self) -> int:
        """Rows that remain searchable (``ntotal`` minus tombstones)."""
        return self._n_built + len(self._stream_ids) - self.ndeleted

    def remove_ids(self, ids) -> int:
        """Tombstone rows by insertion id in every tier: a list or spill
        slot's id becomes -1 in place on its shard, a staged row is dropped.
        Returns the number of rows newly removed."""
        del_ids = np.unique(np.asarray(ids, np.int64).ravel())
        del_ids = del_ids[(del_ids >= 0) & (del_ids < self._next_id)]
        if not len(del_ids):
            return 0
        newly = 0
        tiers = []
        if self._n_built and self._ids is not None:
            tiers.append(self._ids)
        if self._spill is not None:
            tiers.append(self._spill[2])
        for shards in tiers:
            for t in shards:
                hit = np.nonzero(np.isin(t.cpu().numpy(), del_ids))[0]
                if len(hit):
                    t[torch.as_tensor(hit, device=t.device)] = -1
                    newly += len(hit)
        self.ndeleted += newly  # tombstones in the device tiers only
        if len(self._stream_ids):
            # staged rows are dropped outright: they shrink the stream
            # instead of counting in ndeleted
            keep = ~np.isin(self._stream_ids, del_ids)
            dropped = int((~keep).sum())
            if dropped:
                self._stream_vecs = self._stream_vecs[keep]
                self._stream_ids = self._stream_ids[keep]
                self._pending_dev = None
                newly += dropped
        logger.debug("tombstoned %d rows (%d live)", newly, self.nlive)
        return newly

    def rebuild(self) -> None:
        """Fold the stream tier into the lists; surviving rows keep their
        ids."""
        if not len(self._stream_ids) and not self.ndeleted:
            return
        vecs, ids = self.vectors(return_ids=True)
        logger.info("rebuilding sharded IVF with %d vectors", len(vecs))
        self.build(vecs, row_ids=ids)

    def _stripe(self, vecs: np.ndarray, sq: np.ndarray, ids: np.ndarray):
        """Rows dealt round-robin to the shards, each shard's padded to a
        shared multiple of 128: ([vecs], [sq], [ids], [count])."""
        t_pad = int(_round_up(-(-len(ids) // self.n_dev), 128))
        out = ([], [], [], [])
        for j, dev in enumerate(self.devices):
            rows = vecs[j::self.n_dev]
            v = torch.zeros((t_pad,) + vecs.shape[1:], dtype=vecs.dtype)
            s = torch.zeros((t_pad,), dtype=torch.float32)
            i = torch.full((t_pad,), -1, dtype=torch.int32)
            v[:len(rows)], s[:len(rows)] = rows, torch.as_tensor(sq[j::self.n_dev])
            i[:len(rows)] = torch.as_tensor(ids[j::self.n_dev])
            for part, t in zip(out, (v.to(dev), s.to(dev), i.to(dev), len(rows))):
                part.append(t)
        return out

    def _refresh_pending(self) -> None:
        """Copy the host-staged stream tier to the shards."""
        if not len(self._stream_ids):
            self._pending_dev = None
            return
        sq = (self._stream_vecs.astype(np.float32) ** 2).sum(-1)
        vecs = torch.from_numpy(self._stream_vecs).to(self._tier_dtype)
        self._pending_dev = self._stripe(vecs, sq, self._stream_ids)

    # -------------------------------------------------------------- search
    def _dispatch(self, nq: int, nprobe: int, filtered: bool) -> dict:
        """Every shard's fused-search parameters for ``nq`` queries (JAX's
        rule): the union-scan kernel for eligible full-precision storage
        with no filter (the shards' device type decides the platform), with
        at least 16 queries a chunk; the plain chunk body otherwise."""
        union_cap = (self.union_cap if self.union_cap is not None
                     else default_union_cap(self.nlist, nprobe))
        qc = pick_query_chunk(nprobe, self._window, self.dim,
                              4 if self.pq_m else self.dtype.itemsize,  # PQ decodes dense
                              nq, union_cap=union_cap)
        backend, interpret = "xla", False
        if self.backend != "xla" and not filtered and not self.pq_m:
            platform = self.device.type
            if kernel_eligible(platform=platform, quantized=self.quantized,
                               window=self._window, dim=self.dim, qc=max(qc, 16),
                               shadow=None, interpret=self.backend == "pallas"):
                backend, qc = "pallas", max(qc, 16)
                interpret = platform != "cuda"
        return {"nprobe": nprobe, "union_cap": union_cap, "qc": qc, "backend": backend,
                "interpret": interpret,
                "union_mode": "chunkmax" if self.nlist > 2048 else "minrank"}

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probe-limited top-k over every shard: (values, ids), (Q, k), on
        the first db device. ``filter_mask``: optional (ntotal,) bool by
        insertion id, True = searchable, copied to every shard and applied
        before selection; it routes the shards to the plain chunk body (the
        union scan has no filter operand)."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q = dist_ops.as_tensor(queries, self.device, torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        if self.ntotal == 0:
            return (torch.full((nq, k), _fill(self.metric), device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int32, device=self.device))
        filt = None
        if filter_mask is not None:
            filt = dist_ops.as_tensor(filter_mask, self.device, torch.bool)
            if filt.shape[0] != self.ntotal:
                raise ValueError(f"filter_mask has {filt.shape[0]} entries, "
                                 f"index has {self.ntotal} ids")
        if len(self._stream_ids) and self._pending_dev is None:
            self._refresh_pending()
        tiers = [t for t in (self._spill, self._pending_dev) if t is not None]
        disp = self._dispatch(nq, nprobe, filt is not None)
        pq_cb, pq_kernel = self._pq_operands()
        parts = []
        for j, dev in enumerate(self.devices):
            qj = q.to(dev)
            fj = filt.to(dev) if filt is not None else None
            local = [fused_ivf_search_math(
                qj, self._cent_store[j], self._cent_sq[j], self._vecs[j],
                self._scales[j] if self.quantized else None, self._sq[j], self._ids[j],
                None, None, fj, pq_cb[j] if pq_cb is not None else None, pq_kernel,
                k=k, window=self._window, metric=self.metric,
                recall_target=self.recall_target, **disp)]
            local += [_tier_scan(qj, t[0][j], t[1][j], t[2][j], t[3][j], k, self.metric, fj)
                      for t in tiers]
            parts.append(merge_shards(local, k, self.metric, dev) if len(local) > 1
                         else local[0])
        vals, ids = merge_shards(parts, k, self.metric, self.device)
        return pad_to_k(vals, ids, k, self.metric)

    # ------------------------------------------------------------- manage
    def reset(self) -> None:
        self.centroids = None
        self._clear_state()

    def vectors(self, return_ids: bool = False):
        """Live vectors in insertion order (float32 host copies; tombstones
        excluded; int8 rows dequantized, PQ rows reconstructed, spilled rows
        exact in their tier's dtype), and with ``return_ids`` their ids."""
        parts_v, parts_i = [], []
        if self._n_built:
            for j in range(self.n_dev):
                ids = self._ids[j].cpu().numpy()
                live = torch.as_tensor(np.nonzero(ids >= 0)[0], device=self._ids[j].device)
                codes = self._vecs[j][live]
                if self.pq_m:
                    # decoded residual + the slot's list centroid
                    lists = (live // self._window).clamp_max(self.nlist - 1)
                    rows = (pq_ops.pq_decode(self.pq_codebooks.to(codes.device), codes)
                            + self.centroids.to(codes.device)[lists])
                elif self.quantized:
                    rows = dequantize(codes, self._scales[j][live])
                else:
                    rows = codes.float()
                parts_v.append(rows.cpu().numpy())
                parts_i.append(ids[ids >= 0])
            if self._spill is not None:
                for v, i in zip(self._spill[0], self._spill[2]):
                    s_ids = i.cpu().numpy()
                    parts_v.append(v.float().cpu().numpy()[s_ids >= 0])
                    parts_i.append(s_ids[s_ids >= 0])
        if len(self._stream_ids):
            parts_v.append(self._stream_vecs)
            parts_i.append(self._stream_ids)
        if not parts_v:
            empty = np.zeros((0, self.dim), np.float32)
            return (empty, np.zeros((0,), np.int32)) if return_ids else empty
        vecs = np.concatenate(parts_v)
        ids = np.concatenate(parts_i)
        order = np.argsort(ids, kind="stable")
        if return_ids:
            return vecs[order], ids[order].astype(np.int32)
        return vecs[order]

    # ---------------------------------------------------------------- io
    def state_dict(self) -> dict:
        """Exact state in the "sharded_padded_v1" format: live block rows in
        (shard, list, rank) order plus per-shard list lengths, codes and
        scales as stored (int8 bit-exact), the spill tier's live rows and
        the staged stream."""
        state = {
            "kind": "sharded_ivf",
            "format": "sharded_padded_v1",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "window_quantile": self.window_quantile,
            "n_dev": self.n_dev,
            "window": self._window,
            "next_id": self._next_id,
            "n_built": self._n_built,
            "centroids": self.centroids.cpu().numpy() if self.centroids is not None
            else np.zeros((0, self.dim), np.float32),
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
        if self._n_built:
            ids_np = np.stack([t.cpu().numpy() for t in self._ids])  # (n_dev, n_slots)
            live = [torch.as_tensor(np.nonzero(r >= 0)[0], device=t.device)
                    for r, t in zip(ids_np, self._ids)]
            gather = lambda shards: torch.cat([s[p].cpu() for s, p in zip(shards, live)])
            state.update({
                "lengths": (ids_np[:, : self.nlist * self._window]
                            .reshape(self.n_dev, self.nlist, self._window) >= 0)
                .sum(axis=2).astype(np.int32),
                "codes": codec.to_host(gather(self._vecs)),
                "sqnorms": gather(self._sq).numpy(),
                "sorted_ids": ids_np[ids_np >= 0],
            })
            if self.quantized:
                state["scales"] = gather(self._scales).numpy()
            n_spill = 0
            if self._spill is not None:
                sp_vecs, sp_sq, sp_ids, _ = self._spill
                s_ids = [t.cpu().numpy() for t in sp_ids]
                s_live = [torch.as_tensor(np.nonzero(r >= 0)[0], device=t.device)
                          for r, t in zip(s_ids, sp_ids)]
                state.update({
                    "spill_codes": codec.to_host(torch.cat(
                        [v[p].cpu() for v, p in zip(sp_vecs, s_live)])),
                    "spill_sq": torch.cat([s[p].cpu() for s, p in zip(sp_sq, s_live)]).numpy(),
                    "spill_ids": np.concatenate([r[r >= 0] for r in s_ids]),
                })
                n_spill = len(state["spill_ids"])
            # only live rows are saved: the reloaded count is the live one
            state["n_built"] = int((ids_np >= 0).sum()) + n_spill
        if len(self._stream_ids):
            state.update({"stream_vecs": self._stream_vecs, "stream_ids": self._stream_ids})
        return state

    def _install_rows(self, codes: torch.Tensor, sq: torch.Tensor, ids: np.ndarray,
                      scales: Optional[torch.Tensor], dev_of_row: np.ndarray,
                      list_of_row: np.ndarray, window: int) -> None:
        """Scatter live rows into every shard's block-padded lists: the
        index arithmetic on the host, one gather per shard on the first db
        device, then each shard moved to its device."""
        n_live = len(ids)
        order = np.lexsort((ids, list_of_row, dev_of_row))
        dev_s, list_s = dev_of_row[order], list_of_row[order]
        # rank within the (shard, list) group
        group = dev_s.astype(np.int64) * self.nlist + list_s
        first = np.r_[True, group[1:] != group[:-1]] if n_live else np.zeros(0, bool)
        rank = np.arange(n_live) - np.maximum.accumulate(np.where(first, np.arange(n_live), 0))
        n_slots = (self.nlist + 1) * window
        dest = dev_s.astype(np.int64) * n_slots + list_s.astype(np.int64) * window + rank
        src = np.full(self.n_dev * n_slots, n_live, np.int64)
        src[dest] = order
        src = torch.as_tensor(src.reshape(self.n_dev, n_slots), device=self.device)

        def scatter(arr: torch.Tensor, fill):
            arr = arr.to(self.device)
            arr = torch.cat([arr, arr.new_full((1,) + arr.shape[1:], fill)])
            return [arr[src[j]].to(dev) for j, dev in enumerate(self.devices)]

        self._vecs = scatter(codes, 0)
        self._sq = scatter(sq, 0.0)
        self._ids = scatter(torch.as_tensor(ids, dtype=torch.int32), -1)
        self._scales = scatter(scales, 0.0) if scales is not None else None
        self._window = window

    @classmethod
    def from_state_dict(
        cls, state: dict, mesh: Optional[Mesh] = None, **kwargs
    ) -> "ShardedIVFIndex":
        """Index from a ``state_dict`` of either package. The saved rows are
        re-scattered, not re-assigned: onto a mesh of the saved size they
        land in the same slots, onto another size they are re-striped by
        global id (list membership kept, codes as stored). ``mesh``
        defaults to every visible card on a "db" axis (none visible
        raises)."""
        def item(v):
            v = np.asarray(v)
            return v.item() if v.ndim == 0 else v

        if mesh is None:
            mesh = make_mesh()
        pq_kwargs = {}
        if "pq_m" in state:
            pq_kwargs = {"pq_m": int(item(state["pq_m"])),
                         "pq_ksub": int(item(state["pq_ksub"])),
                         "pq_compute": str(item(state["pq_compute"]))}
        idx = cls(dim=int(item(state["dim"])), mesh=mesh, nlist=int(item(state["nlist"])),
                  nprobe=int(item(state["nprobe"])), metric=str(item(state["metric"])),
                  # under PQ the list dtype is re-derived (uint8 codes)
                  dtype="bfloat16" if pq_kwargs else str(item(state["dtype"])),
                  **pq_kwargs, **kwargs)
        dev = idx.device
        cb = np.asarray(state.get("pq_codebooks", np.zeros(0)))
        if cb.size:
            idx.pq_codebooks = torch.tensor(cb, dtype=torch.float32, device=dev)
        if "window_quantile" in state:
            idx.window_quantile = float(item(state["window_quantile"]))
        centroids = np.asarray(state["centroids"])
        if centroids.size:
            idx.centroids = torch.tensor(centroids, dtype=torch.float32, device=dev)

        if str(item(state.get("format", ""))) != "sharded_padded_v1":
            vectors = np.asarray(state["vectors"])  # legacy: insertion order -> rebuild
            if len(vectors):
                idx.build(vectors)
            return idx

        saved_dev = int(item(state["n_dev"]))
        window = int(item(state["window"]))
        idx._next_id = int(item(state["next_id"]))
        idx._n_built = int(item(state["n_built"]))
        if idx._n_built:
            lengths = np.asarray(state["lengths"], np.int64)
            ids = np.asarray(state["sorted_ids"], np.int32)
            codes = codec.from_host(np.asarray(state["codes"]), idx.dtype)
            sq = torch.tensor(np.asarray(state["sqnorms"]), dtype=torch.float32)
            scales = (torch.tensor(np.asarray(state["scales"]), dtype=torch.float32)
                      if idx.quantized else None)
            list_of_row = np.repeat(np.tile(np.arange(idx.nlist), saved_dev),
                                    lengths.reshape(-1))
            if saved_dev == idx.n_dev:
                dev_of_row = np.repeat(np.arange(saved_dev), lengths.sum(axis=1))
            else:
                # another mesh size: re-stripe rows by global id (a pure
                # re-scatter: no re-assignment, codes as stored)
                logger.info("sharded IVF reload across mesh sizes (%d -> %d shards): "
                            "re-striping rows", saved_dev, idx.n_dev)
                per_new = -(-max(int(ids.max()) + 1 if len(ids) else 1, 1) // idx.n_dev)
                dev_of_row = np.minimum(ids // per_new, idx.n_dev - 1)
                new_len = np.zeros((idx.n_dev, idx.nlist), np.int64)
                np.add.at(new_len, (dev_of_row, list_of_row), 1)
                window = int(_round_up(max(int(new_len.max()), 1), 128))
            idx._install_rows(codes, sq, ids, scales, dev_of_row, list_of_row, window)
            idx._install_centroids()
            if "spill_ids" in state:
                # spill rows are scanned exactly wherever they sit: dealt
                # round-robin to the shards
                sp_codes = codec.from_host(np.asarray(state["spill_codes"]), idx._tier_dtype)
                idx._spill = idx._stripe(sp_codes, np.asarray(state["spill_sq"], np.float32),
                                         np.asarray(state["spill_ids"], np.int32))
        if "stream_ids" in state:
            idx._stream_vecs = np.asarray(state["stream_vecs"], np.float32)
            idx._stream_ids = np.asarray(state["stream_ids"], np.int32)
        return idx
