"""Exact distance computation fused with top-k selection, in plain torch.

Counterpart of ``rag_faiss_embedding_tpu/ops/distance.py``, with the same
contract:

- L2 ranks by ``2 q.x - ||x||^2`` with ``||q||^2`` added back at the end, so
  the work is one matrix product per database chunk, accumulated in float32
  (bf16 storage is widened exactly to float32 before the product).
- The database axis is scanned in chunks with a running top-k merge, so the
  full (Q, N) score matrix never exists at once.
- Rows at or past ``n_valid`` and rows marked ``dead`` never come back.
- Ties go to the LOWEST row index (FAISS parity). ``torch.topk`` does not
  promise that, so selection is done by masked-argmax passes
  (``torch.argmax`` returns the first maximum) or a stable sort.

This is the index's path on the CPU and, on any device, for tombstoned or
filtered searches; ``ops/flat_scan.py`` holds the CUDA kernel for the rest.

Conventions: selection runs on a "score" where HIGHER is better (negated L2).
Results are (values, indices): squared L2 distances ascending, or inner
products descending. Missing slots hold index -1 (and inf / -inf).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min


def as_tensor(x, device: Optional[torch.device] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tensor view of a numpy array or tensor, moved / cast only if needed."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def sqnorms(db: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms, float32."""
    dbf = db.float()
    return (dbf * dbf).sum(-1)


def _dots(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, N) float32 dot products. bf16 widens exactly to f32 first, so
    this is the f32-accumulated product JAX asks for with
    ``preferred_element_type=float32``."""
    return q.float() @ db.float().T


def pairwise_l2(q: torch.Tensor, db: torch.Tensor,
                db_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared-L2 distances (Q, N), float32 (``faiss.IndexFlatL2``)."""
    if db_sq is None:
        db_sq = sqnorms(db)
    q_sq = sqnorms(q)[:, None]
    return (q_sq - 2.0 * _dots(q, db) + db_sq[None, :]).clamp_min(0.0)


def pairwise_ip(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Inner-product scores (Q, N), float32 (``faiss.IndexFlatIP``)."""
    return _dots(q, db)


def small_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties to the LOWEST index.

    k masked-argmax passes over a copy of ``x``; for k >= the row length a
    stable descending sort gives the same order."""
    n, m = x.shape
    if k >= m:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k].to(torch.int32)
    sent = (
        torch.iinfo(x.dtype).min
        if not x.dtype.is_floating_point
        else float("-inf")
    )
    cur = x.clone()
    vals = torch.empty((n, k), dtype=x.dtype, device=x.device)
    idxs = torch.empty((n, k), dtype=torch.int64, device=x.device)
    for j in range(k):
        i = torch.argmax(cur, dim=1, keepdim=True)
        vals[:, j:j + 1] = torch.gather(x, 1, i)
        idxs[:, j:j + 1] = i
        cur.scatter_(1, i, sent)
    return vals, idxs.to(torch.int32)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties to the lowest index, for any k:
    ``small_topk`` up to 16, a stable descending sort above."""
    if k <= 16:
        return small_topk(x, k)
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def merge_topk(vals_a: torch.Tensor, idx_a: torch.Tensor,
               vals_b: torch.Tensor, idx_b: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k candidate sets (higher-is-better scores). Equal
    scores keep the order of the concatenation [a, b]."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    best, pos = small_topk(vals, k)
    return best, torch.gather(idx, 1, pos.long())


def finish_topk(best_v: torch.Tensor, best_i: torch.Tensor, q_sq: torch.Tensor,
                k: int, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selected scores -> public values: slots still at NEG_INF become
    -1 / inf (-inf for IP), L2 adds the query norms ``q_sq`` back, and
    k > N pads."""
    nq, k_eff = best_v.shape
    valid = best_v > NEG_INF
    best_i = torch.where(valid, best_i, torch.full_like(best_i, -1))
    if metric == "L2":
        dist = (q_sq[:, None] - best_v).clamp_min(0.0)
        values = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    else:
        values = torch.where(valid, best_v,
                             torch.full_like(best_v, float("-inf")))
    if k_eff < k:  # corpus smaller than k: pad out to the requested k
        fill = float("inf") if metric == "L2" else float("-inf")
        values = torch.cat(
            [values, values.new_full((nq, k - k_eff), fill)], dim=1)
        best_i = torch.cat(
            [best_i, best_i.new_full((nq, k - k_eff), -1)], dim=1)
    return values, best_i


def exact_search(
    q,
    db,
    k: int,
    *,
    metric: str = "L2",
    db_sq=None,
    n_valid: Optional[int] = None,
    chunk_size: int = 524288,
    selector: str = "exact",
    recall_target: float = 0.99,
    dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scan over ``db`` for a batch of queries.

    Args:
      q: (Q, D) queries; db: (N, D) database (rows past ``n_valid`` are
        padding). Either may be a numpy array; results live on ``db``'s
        device.
      metric: "L2" (squared L2, ascending) or "IP" (descending).
      db_sq: optional precomputed float32 row squared norms, (N,).
      n_valid: number of real rows; rows >= n_valid are masked out.
      chunk_size: database rows per scan step.
      selector: "exact" or "approx"; both select exactly (JAX's
        ``lax.approx_max_k`` is an exact top-k off the TPU), so
        ``recall_target`` is taken for the JAX signature only.
      dead: optional (N,) bool tombstones; True rows are never returned.

    Returns:
      (values, indices): (Q, k) float32 and int32. Invalid slots
      (k > live rows) hold index -1, FAISS-style.
    """
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    db = as_tensor(db)
    q = as_tensor(q, device=db.device)
    n = db.shape[0]
    nq = q.shape[0]
    nv = n if n_valid is None else int(n_valid)
    chunk_size = min(chunk_size, max(1, n))
    k_eff = min(k, n)
    if metric == "L2":
        db_sq = sqnorms(db) if db_sq is None else as_tensor(db_sq, db.device)
    if dead is not None:
        dead = as_tensor(dead, db.device, torch.bool)

    best_v = torch.full((nq, k_eff), NEG_INF, dtype=torch.float32,
                        device=db.device)
    best_i = torch.full((nq, k_eff), -1, dtype=torch.int32, device=db.device)
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        dots = _dots(q, db[start:stop])
        if metric == "L2":
            scores = 2.0 * dots - db_sq[None, start:stop]
        else:
            scores = dots
        live = torch.arange(start, stop, device=db.device) < nv
        if dead is not None:
            live = live & ~dead[start:stop]
        scores = scores.masked_fill(~live[None, :], NEG_INF)
        cv, cp = small_topk(scores, min(k_eff, stop - start))
        best_v, best_i = merge_topk(best_v, best_i, cv, cp + start, k_eff)
    return finish_topk(best_v, best_i, sqnorms(q), k, metric)
