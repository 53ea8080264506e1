"""Device-resident exact (flat) vector index.

Counterpart of ``rag_faiss_embedding_tpu/index/flat.py`` (the
``faiss.IndexFlatL2`` / ``IndexFlatIP`` replacement):

- vectors live on ``device`` in a preallocated buffer whose capacity is a
  multiple of 1024 rows and doubles on growth, with an ``ntotal`` watermark;
- row squared norms are computed at add time, from the stored dtype;
- storage is float32 (rank-order parity with a float32 exact scan),
  bfloat16 (float32 accumulation retained) or int8 (the FAISS SQ8 analog:
  per-row scales, exact float32 norms taken before quantization, and with
  ``selector="rerank"`` a bfloat16 shadow of every row; ``ops/quantize``);
- ``remove_ids`` tombstones and a search-time ``filter_mask`` mask rows out;
- ``state_dict`` writes the JAX package's npz layout, so either package
  loads the other's index.

Routing: a float32 / bfloat16 index sends every search, with either
selector ("approx" is met by the exact scan), to the flat-scan wrapper
(``ops/flat_scan.flat_search``): on a CUDA index it launches the kernel, at
any k and with tombstones and filters as the kernel's row mask; on a CPU
index it runs the plain chunked scan (``ops/distance.exact_search``). A
kernel error raises; ``flat_search.launches`` counts the card's searches.
An int8 index searches with ``ops/quantize.int8_search`` ("exact",
"approx") or ``int8_rerank_search`` ("rerank"), whose int8 product is
``torch._int_mm`` on the card.

A file with a shadow reloads as selector "rerank" unless the caller asks
for another (the JAX index reloads it as "exact" and drops the shadow).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.logging import get_logger

from .. import default_device
from ..ops import distance as dist_ops
from ..ops import flat_scan
from ..ops.quantize import (
    DEFAULT_INT8_RECALL_TARGET, dequantize, int8_rerank_search, int8_search, quantize_rows,
)
from . import codec

logger = get_logger(__name__)

_ROW_ALIGN = 1024  # capacity is kept a multiple of this
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"dtype must be 'float32', 'bfloat16' or 'int8', got {dtype!r}")
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
        use_pallas: Optional[bool] = None,
        selector: str = "exact",
        recall_target: Optional[float] = None,
        rerank_shadow: bool = True,
    ):
        if selector not in ("exact", "approx", "rerank"):
            raise ValueError(
                f"selector must be 'exact', 'approx' or 'rerank', got {selector!r}")
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        self.dim = int(dim)
        self.metric = metric
        self.dtype_name = _dtype_name(dtype)
        self.dtype = _DTYPES[self.dtype_name]
        self.quantized = self.dtype == torch.int8
        if selector == "rerank" and not self.quantized:
            raise ValueError("selector='rerank' requires dtype='int8'")
        if recall_target is None:
            # JAX's defaults; selection is exact here, so they only travel
            recall_target = (DEFAULT_INT8_RECALL_TARGET
                             if self.quantized and selector != "rerank" else 0.99)
        self.recall_target = float(recall_target)
        self.selector = selector
        # taken so that JAX calls run; no effect: the JAX index picks its
        # kernel or its lax scan with it, and the port's card has one route
        self._use_pallas = use_pallas
        self.device = torch.device(device) if device is not None else default_device()
        self.ntotal = 0
        self._capacity = _round_up(int(capacity), _ROW_ALIGN)
        self._buf = torch.zeros((self._capacity, self.dim), dtype=self.dtype,
                                device=self.device)
        self._sq = torch.zeros((self._capacity,), dtype=torch.float32,
                               device=self.device)
        # int8: per-row scales, and for the rerank a bf16 copy of every row
        # (2 bytes a dimension on top of the 1-byte codes)
        self._scales = (torch.zeros((self._capacity,), dtype=torch.float32,
                                    device=self.device) if self.quantized else None)
        self._shadow = (torch.zeros((self._capacity, self.dim), dtype=torch.bfloat16,
                                    device=self.device)
                        if selector == "rerank" and rerank_shadow else None)
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
        grow = lambda t: torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        self._buf, self._sq = grow(self._buf), grow(self._sq)
        if self._scales is not None:
            self._scales = grow(self._scales)
        if self._shadow is not None:
            self._shadow = grow(self._shadow)
        if self._dead is not None:
            self._dead = grow(self._dead)
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
        # in place at the watermark (the JAX index's dynamic_update_slice):
        # rows past ntotal are never read, so no copy of the buffer is made
        rows = slice(self.ntotal, self.ntotal + n_new)
        if self.quantized:
            vecs = vecs.to(device=self.device, dtype=torch.float32)
            self._sq[rows] = dist_ops.sqnorms(vecs)  # exact, before quantization
            self._buf[rows], self._scales[rows] = quantize_rows(vecs)
            if self._shadow is not None:
                self._shadow[rows] = vecs.to(torch.bfloat16)
        else:
            vecs = vecs.to(device=self.device, dtype=self.dtype)
            self._buf[rows] = vecs
            self._sq[rows] = dist_ops.sqnorms(vecs)
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
    def search(self, queries, k: int, chunk_size: int = 524288,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k, exact over the stored rows (int8: over the quantized
        scores, then the shadow's for "rerank"). Returns (values, indices)
        on the index's device, (Q, k). L2 values are squared distances
        ascending; IP values descend. Missing slots (k > live rows) hold
        index -1.

        ``filter_mask``: optional (ntotal,) bool, True = searchable (the
        FAISS ``IDSelector`` analog), applied inside the scan."""
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
        if self.quantized:
            qf = q.to(device=self.device, dtype=torch.float32)
            q_i8, q_scale = quantize_rows(qf)
            kw = dict(metric=self.metric, n_valid=self.ntotal,
                      chunk_size=min(chunk_size, self._capacity),
                      recall_target=self.recall_target, dead=dead)
            if self.selector == "rerank":
                return int8_rerank_search(
                    qf, q_i8, q_scale, dist_ops.sqnorms(qf), self._buf, self._scales,
                    self._sq, self._shadow, k, cand_per_chunk=max(2 * k, 16), **kw)
            return int8_search(q_i8, q_scale, dist_ops.sqnorms(qf), self._buf,
                               self._scales, self._sq, k, selector=self.selector, **kw)
        q = q.to(device=self.device, dtype=self.dtype)
        return flat_scan.flat_search(
            q, self._buf, k, metric=self.metric, db_sq=self._sq,
            n_valid=self.ntotal, dead=dead, chunk_size=chunk_size)

    # ------------------------------------------------------------- manage
    def reset(self) -> None:
        """Drop all vectors (reference ``faiss_store.py:124-128``)."""
        self.ntotal = 0
        self.ndeleted = 0
        self._dead = None
        for t in (self._buf, self._sq, self._scales, self._shadow):
            if t is not None:
                t.zero_()

    def vectors(self) -> np.ndarray:
        """Host copy of the live rows as float32: bf16 widened, int8
        dequantized."""
        rows = self._buf[: self.ntotal]
        if self.quantized:
            rows = dequantize(rows, self._scales[: self.ntotal])
        return rows.float().cpu().numpy()

    # ---------------------------------------------------------------- io
    def state_dict(self) -> dict:
        n = self.ntotal
        state = {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "vectors": codec.to_host(self._buf[:n]),
        }
        if self.quantized:  # lossless reload: codes, scales and exact norms
            state["scales"] = self._scales[:n].cpu().numpy()
            state["sqnorms"] = self._sq[:n].cpu().numpy()
            if self._shadow is not None:
                state["shadow"] = codec.to_host(self._shadow[:n])
        if self.ndeleted:
            state["dead"] = self._dead[:n].cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state: dict, **kwargs) -> "FlatIndex":
        """Index from a ``state_dict`` of either package. An int8 state with
        a ``shadow`` builds a "rerank" index unless ``selector`` is given;
        asked for "rerank" without one, the shadow is rebuilt (lossy) from
        the dequantized codes."""
        if "shadow" in state:
            kwargs.setdefault("selector", "rerank")
        idx = cls(
            dim=int(state["dim"]),
            metric=str(state["metric"]),
            dtype=str(state["dtype"]),
            **kwargs,
        )
        vecs = np.asarray(state["vectors"])
        n = len(vecs)
        if n == 0:
            return idx
        if idx.quantized and "scales" in state:
            idx._grow(n)
            dev = idx.device
            idx._buf[:n] = torch.tensor(vecs, dtype=torch.int8, device=dev)
            idx._scales[:n] = torch.tensor(np.asarray(state["scales"]), device=dev)
            idx._sq[:n] = torch.tensor(np.asarray(state["sqnorms"]), device=dev)
            if idx._shadow is not None:
                idx._shadow[:n] = (
                    codec.from_host(state["shadow"], torch.bfloat16).to(dev)
                    if "shadow" in state else dequantize(idx._buf[:n], idx._scales[:n]))
            idx.ntotal = n
        elif idx.dtype == torch.bfloat16 and vecs.dtype != np.float32:
            # uint16 bit pattern (or legacy void "|V2") -> bf16, exactly
            idx.add(codec.from_host(vecs, torch.bfloat16))
        else:
            idx.add(vecs)
        if "dead" in state:
            idx.remove_ids(np.nonzero(np.asarray(state["dead"], bool))[0])
        return idx
