"""Device-resident exact (flat) vector index.

Counterpart of ``rag_faiss_embedding_tpu/index/flat.py`` (the
``faiss.IndexFlatL2`` / ``IndexFlatIP`` replacement):

- vectors live on ``device`` in a preallocated buffer whose capacity is a
  multiple of 1024 rows and doubles on growth, with an ``ntotal`` watermark;
- row squared norms are computed at add time, from the stored dtype;
- storage is float32 (rank-order parity with a float32 exact scan) or
  bfloat16 (float32 accumulation retained);
- ``remove_ids`` tombstones and a search-time ``filter_mask`` mask rows out;
- ``state_dict`` writes the JAX package's npz layout, so either package
  loads the other's index.

Search on a CUDA index with no tombstones or filter runs the CUDA flat-scan
kernel (``ops/flat_scan.py``). With a mask it runs the plain chunked scan
(``ops/distance.py``) on the card, as the JAX package runs its lax scan when
its kernel has no mask operand. A CPU index runs the plain scan. A CUDA
index serves k up to the kernel's ``KMAX`` (64), masked or not; ``check_k``
raises ``ValueError`` above it.

Not ported yet: int8 storage and the "approx" / "rerank" selectors (the int8
tier).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rag_faiss_embedding_tpu.core.logging import get_logger

from .. import default_device
from ..ops import distance as dist_ops
from ..ops import flat_scan
from . import codec

logger = get_logger(__name__)

_ROW_ALIGN = 1024  # capacity is kept a multiple of this
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name == "int8":
        raise NotImplementedError(
            "int8 flat storage is not ported yet (the int8 tier)")
    if name not in _DTYPES:
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
    return name


class FlatIndex:
    """Exact nearest-neighbor index over a device-resident buffer."""

    def __init__(
        self,
        dim: int,
        metric: str = "L2",
        dtype: str | torch.dtype = "float32",
        capacity: int = _ROW_ALIGN,
        device: Optional[torch.device | str] = None,
        selector: str = "exact",
    ):
        if selector in ("approx", "rerank"):
            raise NotImplementedError(
                f"selector={selector!r} is not ported yet (the int8 tier)")
        if selector != "exact":
            raise ValueError(
                f"selector must be 'exact', 'approx' or 'rerank', got {selector!r}")
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        self.dim = int(dim)
        self.metric = metric
        self.dtype_name = _dtype_name(dtype)
        self.dtype = _DTYPES[self.dtype_name]
        self.selector = selector
        self.device = torch.device(device) if device is not None else default_device()
        self.ntotal = 0
        self._capacity = _round_up(int(capacity), _ROW_ALIGN)
        self._buf = torch.zeros((self._capacity, self.dim), dtype=self.dtype,
                                device=self.device)
        self._sq = torch.zeros((self._capacity,), dtype=torch.float32,
                               device=self.device)
        # tombstones (remove_ids); allocated on first removal so the common
        # no-deletion search goes to the kernel
        self._dead: Optional[torch.Tensor] = None
        self.ndeleted = 0

    # ---------------------------------------------------------------- add
    def _grow(self, needed: int) -> None:
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        pad = new_cap - self._capacity
        self._buf = torch.cat([self._buf, self._buf.new_zeros((pad, self.dim))])
        self._sq = torch.cat([self._sq, self._sq.new_zeros((pad,))])
        if self._dead is not None:
            self._dead = torch.cat([self._dead, self._dead.new_zeros((pad,))])
        self._capacity = new_cap
        logger.debug("grew flat index capacity to %d rows", new_cap)

    def add(self, vectors) -> None:
        """Append vectors at the watermark (streaming add)."""
        vecs = dist_ops.as_tensor(vectors)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vecs.shape[-1]}")
        n_new = vecs.shape[0]
        self._grow(self.ntotal + n_new)
        vecs = vecs.to(device=self.device, dtype=self.dtype)
        # in place at the watermark (the JAX index's dynamic_update_slice):
        # rows past ntotal are never read, so no copy of the buffer is made
        self._buf[self.ntotal:self.ntotal + n_new] = vecs
        self._sq[self.ntotal:self.ntotal + n_new] = dist_ops.sqnorms(vecs)
        self.ntotal += n_new

    # ------------------------------------------------------------ remove
    @property
    def nlive(self) -> int:
        """Rows that remain searchable (``ntotal`` minus tombstones)."""
        return self.ntotal - self.ndeleted

    def remove_ids(self, ids) -> int:
        """Tombstone rows by position (``faiss.Index.remove_ids`` analog).
        Positions stay stable; already-removed and out-of-range ids are
        ignored. Returns the number of rows newly removed."""
        pos = np.unique(np.asarray(ids, np.int64).ravel())
        pos = pos[(pos >= 0) & (pos < self.ntotal)]
        if not len(pos):
            return 0
        if self._dead is None:
            self._dead = torch.zeros((self._capacity,), dtype=torch.bool,
                                     device=self.device)
        pos_t = torch.as_tensor(pos, device=self.device)
        newly = int(len(pos) - int(self._dead[pos_t].sum()))
        self._dead[pos_t] = True
        self.ndeleted += newly
        logger.debug("tombstoned %d rows (%d live)", newly, self.nlive)
        return newly

    # ------------------------------------------------------------- search
    def check_k(self, k: int) -> None:
        """Raise ``ValueError`` for a k this index cannot serve (above the
        kernel's ``KMAX`` on a CUDA index; any k on the CPU)."""
        if self.device.type == "cuda":
            flat_scan.check_k(k)

    def search(self, queries, k: int, chunk_size: int = 524288,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k. Returns (values, indices) on the index's device,
        (Q, k). L2 values are squared distances ascending; IP values
        descend. Missing slots (k > live rows) hold index -1.

        ``filter_mask``: optional (ntotal,) bool, True = searchable (the
        FAISS ``IDSelector`` analog), applied inside the scan."""
        self.check_k(k)
        q = dist_ops.as_tensor(queries)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        if self.ntotal == 0:
            fill = float("inf") if self.metric == "L2" else float("-inf")
            return (
                torch.full((nq, k), fill, dtype=torch.float32, device=self.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=self.device),
            )
        dead = self._dead
        if filter_mask is not None:
            block = ~dist_ops.as_tensor(filter_mask, self.device, torch.bool)
            if block.shape[0] != self.ntotal:
                raise ValueError(
                    f"filter_mask has {block.shape[0]} entries, "
                    f"index has {self.ntotal}")
            block = torch.cat([block, block.new_zeros(self._capacity - self.ntotal)])
            dead = block if dead is None else (dead | block)
        q = q.to(device=self.device, dtype=self.dtype)
        if self.device.type == "cuda" and dead is None:
            return flat_scan.flat_search(
                q, self._buf, k, metric=self.metric,
                db_sq=self._sq, n_valid=self.ntotal)
        return dist_ops.exact_search(
            q, self._buf, k, metric=self.metric, db_sq=self._sq,
            n_valid=self.ntotal, chunk_size=chunk_size, dead=dead)

    # ------------------------------------------------------------- manage
    def reset(self) -> None:
        """Drop all vectors (reference ``faiss_store.py:124-128``)."""
        self.ntotal = 0
        self.ndeleted = 0
        self._dead = None
        self._buf.zero_()
        self._sq.zero_()

    def vectors(self) -> np.ndarray:
        """Host copy of the live rows, float32 for bf16 storage."""
        return self._buf[: self.ntotal].float().cpu().numpy()

    # ---------------------------------------------------------------- io
    def state_dict(self) -> dict:
        state = {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "vectors": codec.to_host(self._buf[: self.ntotal]),
        }
        if self.ndeleted:
            state["dead"] = self._dead[: self.ntotal].cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state: dict, **kwargs) -> "FlatIndex":
        idx = cls(
            dim=int(state["dim"]),
            metric=str(state["metric"]),
            dtype=str(state["dtype"]),
            **kwargs,
        )
        vecs = np.asarray(state["vectors"])
        if len(vecs) == 0:
            return idx
        if idx.dtype == torch.bfloat16 and vecs.dtype != np.float32:
            # uint16 bit pattern (or legacy void "|V2") -> bf16, exactly
            idx.add(codec.from_host(vecs, torch.bfloat16))
        else:
            idx.add(vecs)
        if "dead" in state:
            idx.remove_ids(np.nonzero(np.asarray(state["dead"], bool))[0])
        return idx
