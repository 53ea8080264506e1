"""Product-quantized flat index (the FAISS ``IndexPQ`` analog).

Counterpart of ``rag_faiss_embedding_tpu/index/pq.py``, with the same
arguments, management surface and npz layout:

- rows are stored as M-byte codes plus a float32 reconstruction norm in
  capacity-doubling buffers on ``device`` (M = dim // 8 by default);
- training is lazy on the first ``add`` (or explicit ``train`` /
  ``build``); ``opq=True`` also learns an orthogonal rotation, applied to
  rows before encoding and to queries before the scan;
- search is the ADC scan of ``ops/pq.pq_search`` (decode -> one product per
  chunk -> running top-k), distances exact to the reconstruction;
- ``remove_ids`` tombstones by position, ``filter_mask`` masks at search
  time, ``reset`` keeps the codebooks, ``vectors`` un-rotates;
- ``state_dict`` writes the JAX package's keys, so either package loads the
  other's index.

``backend``: "auto" and "pallas" decode through the kernel wrapper
(``ops/pq_decode.decode``: the CUDA kernel on a CUDA index, its plain
version on a CPU one); "xla" takes the plain decode. There is no k limit
(no flat-scan kernel is involved).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rag_faiss_embedding_tpu.core.logging import get_logger

from .. import default_device
from ..ops import distance as dist_ops
from ..ops import pq as pq_ops
from .flat import _ROW_ALIGN, _round_up

logger = get_logger(__name__)


class PQIndex:
    """Product-quantized index, exact over the reconstructions."""

    # the storage is quantized (callers that branch on storage read this)
    quantized = True

    def __init__(
        self,
        dim: int,
        m: Optional[int] = None,
        ksub: int = 256,
        metric: str = "L2",
        capacity: int = _ROW_ALIGN,
        device: Optional[torch.device | str] = None,
        train_iters: int = 25,
        seed: int = 0,
        compute_dtype: str = "bf16",
        backend: str = "auto",
        opq: bool = False,
    ):
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        if m is None:
            m = max(1, dim // 8)
        if dim % m:
            raise ValueError(f"dim {dim} not divisible by M={m}")
        if not 2 <= ksub <= 256:
            raise ValueError("ksub must be in [2, 256] (uint8 codes)")
        if compute_dtype not in ("bf16", "f32"):
            raise ValueError("compute_dtype must be 'bf16' or 'f32'")
        if backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"bad backend {backend!r}")
        self.backend = backend
        self.dim = int(dim)
        self.m = int(m)
        self.ksub = int(ksub)
        self.metric = metric
        self.compute_dtype = compute_dtype
        self.train_iters = int(train_iters)
        self.seed = int(seed)
        self.device = torch.device(device) if device is not None else default_device()
        self.codebooks: Optional[torch.Tensor] = None  # (M, ksub, dsub) f32
        self.opq = bool(opq)
        self.rotation: Optional[torch.Tensor] = None   # (D, D) f32
        self.is_trained = False
        self.ntotal = 0
        self.ndeleted = 0
        self._capacity = _round_up(int(capacity), _ROW_ALIGN)
        self._codes = torch.zeros((self._capacity, self.m), dtype=torch.uint8,
                                  device=self.device)
        self._sq = torch.zeros((self._capacity,), dtype=torch.float32, device=self.device)
        self._dead: Optional[torch.Tensor] = None

    @property
    def nlive(self) -> int:
        return self.ntotal - self.ndeleted

    # ------------------------------------------------------------ training
    def train(self, vectors) -> None:
        """Train the subspace codebooks; with ``opq`` also the rotation."""
        vecs = dist_ops.as_tensor(vectors, self.device, torch.float32)
        if self.opq:
            self.rotation, cb = pq_ops.train_opq(
                vecs, self.m, ksub=self.ksub, n_iters=self.train_iters, seed=self.seed)
        else:
            cb = pq_ops.train_pq(vecs, self.m, ksub=self.ksub,
                                 n_iters=self.train_iters, seed=self.seed)
        self.codebooks = cb
        self.is_trained = True

    def _rotate(self, rows: torch.Tensor) -> torch.Tensor:
        return rows @ self.rotation if self.rotation is not None else rows

    # ---------------------------------------------------------------- add
    def _grow(self, needed: int) -> None:
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        pad = new_cap - self._capacity
        self._codes = torch.cat([self._codes, self._codes.new_zeros((pad, self.m))])
        self._sq = torch.cat([self._sq, self._sq.new_zeros((pad,))])
        if self._dead is not None:
            self._dead = torch.cat([self._dead, self._dead.new_zeros((pad,))])
        self._capacity = new_cap
        logger.debug("grew PQ index capacity to %d rows", new_cap)

    def add(self, vectors) -> None:
        """Encode and append at the watermark; trains on the first batch if
        the index is untrained."""
        vecs = dist_ops.as_tensor(vectors, self.device, torch.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vecs.shape[-1]}")
        if not self.is_trained:
            logger.info("PQ index untrained; training on first %d rows", vecs.shape[0])
            self.train(vecs)
        n_new = vecs.shape[0]
        self._grow(self.ntotal + n_new)
        codes, sq = pq_ops.pq_encode(self.codebooks, self._rotate(vecs))
        self._codes[self.ntotal:self.ntotal + n_new] = codes
        self._sq[self.ntotal:self.ntotal + n_new] = sq
        self.ntotal += n_new

    def build(self, vectors) -> None:
        """Train and add in one call."""
        self.train(vectors)
        self.add(vectors)

    # ------------------------------------------------------------- remove
    def remove_ids(self, ids) -> int:
        """Tombstone rows by position; returns the number newly removed."""
        pos = np.unique(np.asarray(ids, np.int64).ravel())
        pos = pos[(pos >= 0) & (pos < self.ntotal)]
        if not len(pos):
            return 0
        if self._dead is None:
            self._dead = torch.zeros((self._capacity,), dtype=torch.bool, device=self.device)
        pos_t = torch.as_tensor(pos, device=self.device)
        newly = int(len(pos) - int(self._dead[pos_t].sum()))
        self._dead[pos_t] = True
        self.ndeleted += newly
        logger.debug("tombstoned %d rows (%d live)", newly, self.nlive)
        return newly

    # ------------------------------------------------------------- search
    def check_k(self, k: int) -> None:
        """Any k is served (no flat-scan kernel limit applies)."""

    def search(self, queries, k: int, chunk_size: int = 524288,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """ADC top-k: (values, ids), (Q, k), on the index's device; the
        contract of ``FlatIndex.search``."""
        q = dist_ops.as_tensor(queries, self.device, torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        if self.ntotal == 0:
            fill = float("inf") if self.metric == "L2" else float("-inf")
            return (torch.full((nq, k), fill, device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int32, device=self.device))
        dead = self._dead
        if filter_mask is not None:
            block = ~dist_ops.as_tensor(filter_mask, self.device, torch.bool)
            if block.shape[0] != self.ntotal:
                raise ValueError(f"filter_mask has {block.shape[0]} entries, "
                                 f"index has {self.ntotal}")
            block = torch.cat([block, block.new_zeros(self._capacity - self.ntotal)])
            dead = block if dead is None else (dead | block)
        return pq_ops.pq_search(
            self._rotate(q), self._codes, self.codebooks, self._sq, k,
            metric=self.metric, n_valid=self.ntotal,
            chunk_size=min(chunk_size, self._capacity), dead=dead,
            compute_dtype=self.compute_dtype, pq_w=self.backend != "xla")

    # ------------------------------------------------------------- manage
    def reset(self) -> None:
        """Drop all vectors; the codebooks (and rotation) are kept."""
        self.ntotal = 0
        self.ndeleted = 0
        self._dead = None
        self._codes.zero_()
        self._sq.zero_()

    def vectors(self) -> np.ndarray:
        """Reconstructions of the live rows in position order, in the
        original basis (float32 host copy)."""
        if self.ntotal == 0:
            return np.zeros((0, self.dim), np.float32)
        rec = pq_ops.pq_decode(self.codebooks, self._codes[:self.ntotal])
        if self.rotation is not None:
            rec = rec @ self.rotation.T
        if self._dead is not None:
            rec = rec[~self._dead[:self.ntotal]]
        return rec.cpu().numpy()

    # ---------------------------------------------------------------- io
    def state_dict(self) -> dict:
        state = {
            "kind": "pq",
            "dim": self.dim,
            "m": self.m,
            "ksub": self.ksub,
            "metric": self.metric,
            "compute_dtype": self.compute_dtype,
            "codebooks": self.codebooks.cpu().numpy() if self.codebooks is not None
            else np.zeros((self.m, 0, self.dim // self.m), np.float32),
            "codes": self._codes[:self.ntotal].cpu().numpy(),
            "sqnorms": self._sq[:self.ntotal].cpu().numpy(),
        }
        if self.rotation is not None:
            state["rotation"] = self.rotation.cpu().numpy()
        if self.ndeleted:
            state["dead"] = self._dead[:self.ntotal].cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state: dict, **kwargs) -> "PQIndex":
        def item(v):
            v = np.asarray(v)
            return v.item() if v.ndim == 0 else v

        idx = cls(dim=int(item(state["dim"])), m=int(item(state["m"])),
                  ksub=int(item(state["ksub"])), metric=str(item(state["metric"])),
                  compute_dtype=str(item(state.get("compute_dtype", "bf16"))),
                  opq="rotation" in state, **kwargs)
        if "rotation" in state:
            idx.rotation = dist_ops.as_tensor(np.asarray(state["rotation"]), idx.device,
                                              torch.float32)
        codebooks = np.asarray(state["codebooks"])
        if codebooks.size:
            idx.codebooks = dist_ops.as_tensor(codebooks, idx.device, torch.float32)
            idx.is_trained = True
        codes = np.asarray(state["codes"], np.uint8)
        n = len(codes)
        if n:
            idx._grow(n)
            idx._codes[:n] = torch.from_numpy(codes).to(idx.device)
            idx._sq[:n] = dist_ops.as_tensor(np.asarray(state["sqnorms"], np.float32),
                                             idx.device)
            idx.ntotal = n
        if "dead" in state:
            idx.remove_ids(np.nonzero(np.asarray(state["dead"], bool))[0])
        return idx
