"""Int8 scalar quantization and the int8 search tier (the FAISS SQ8 analog).

Counterpart of ``rag_faiss_embedding_tpu/ops/quantize.py``: each row stores
``round(x / scale)`` in int8 with ``scale = max|x| / 127`` (round half to
even in both frameworks, so the codes are bit-identical), and the scans keep
the exact float32 row norms taken before quantization, so only the cross
term ``q . x`` carries quantization error:

    ||q - x||^2  ~=  ||q||^2 - 2 * sq * sx * <q_i8, x_i8> + ||x||^2

- ``int8_dots`` is the int8 x int8 -> int32 product: ``torch._int_mm`` on a
  CUDA tensor (query rows padded past 16 and to a multiple of 8, as its
  kernel asks; zero columns where D is not a multiple of 8, which leave every
  dot unchanged), the float product of the codes elsewhere. The float product
  is exact, not approximate: every partial sum is an integer below
  D x 127^2, under 2^24 for D <= 1,040 (float64 above), so the two routes
  agree bit for bit. ``int8_dots.launches`` counts the card's products.
- After the product the float order is JAX's: ``dots * q_scale * scale``,
  then ``2 * dots - ||x||^2`` for L2.
- Selection is exact with ties to the lowest index (``small_topk`` /
  ``merge_topk``): ``lax.approx_max_k`` is an exact top-k off the TPU, so
  ``selector="approx"`` and ``recall_target`` select exactly here.
- The database axis is scanned in chunks of ``chunk_size`` rows and the
  query axis in blocks whose score matrix stays under ``_SCORE_BYTES``; the
  query blocks change nothing in the result, the chunks change the rerank's
  candidate set (as in JAX).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .distance import NEG_INF, finish_topk, merge_topk, small_topk

# measured-gated default of the int8 "approx" selector in the JAX package
# (its docs/PERF.md): the quantized cross term, not selection, is the binding
# loss; selector="rerank" is the one that passes the 0.99 recall gate
DEFAULT_INT8_RECALL_TARGET = 0.995
# widest D whose int8 dot products are exact in a float32 sum
_F32_EXACT_MAX_DIM = (1 << 24) // (127 * 127)
# bytes of one (query block x chunk) float32 score matrix
_SCORE_BYTES = 1 << 29


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 per-row scales) of (N, D) rows."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """float32 rows back from int8 values and per-row scales."""
    return q.float() * scales[:, None]


def int8_dots_reference(q_i8: torch.Tensor, db_i8: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 dot products of int8 rows, as an exact float product."""
    ft = torch.float32 if q_i8.shape[1] <= _F32_EXACT_MAX_DIM else torch.float64
    return (q_i8.to(ft) @ db_i8.to(ft).T).to(torch.int32)


def int8_dots(q_i8: torch.Tensor, db_i8: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 = ``q_i8 @ db_i8.T`` for int8 (Q, D) and (N, D) rows.

    On a CUDA tensor: ``torch._int_mm`` on ``db_i8.T`` (a column-major view
    of the row-major rows, no copy); a copy is made only where D or N is not
    a multiple of 8. Elsewhere: ``int8_dots_reference``."""
    if db_i8.device.type != "cuda":
        return int8_dots_reference(q_i8, db_i8)
    nq, d = q_i8.shape
    n = db_i8.shape[0]
    rows = max(24, -(-nq // 8) * 8)  # more than 16, a multiple of 8
    d8, n8 = -(-d // 8) * 8, -(-n // 8) * 8
    q = q_i8.new_zeros((rows, d8))
    q[:nq, :d] = q_i8
    if (d8, n8) != (d, n):
        padded = db_i8.new_zeros((n8, d8))
        padded[:n, :d] = db_i8
        db_i8 = padded
    out = torch._int_mm(q, db_i8.T)
    int8_dots.launches += 1
    return out[:nq, :n]


int8_dots.launches = 0


def _chunk_scores(q_i8, q_scale, db_i8, db_scale, db_sq, start: int, stop: int,
                  nv: int, dead, metric: str, width: int) -> torch.Tensor:
    """Internal scores (higher better) of a query block against rows
    ``start:stop``: masked rows (at or past ``nv``, dead) at NEG_INF, and
    NEG_INF columns appended up to ``width`` where the chunk is shorter
    (JAX pads the last chunk)."""
    s = int8_dots(q_i8, db_i8[start:stop]).float()
    s.mul_(q_scale[:, None]).mul_(db_scale[None, start:stop])
    if metric == "L2":
        s.mul_(2.0).sub_(db_sq[None, start:stop])
    live = torch.arange(start, stop, device=s.device) < nv
    if dead is not None:
        live &= ~dead[start:stop]
    s.masked_fill_(~live[None, :], NEG_INF)
    if stop - start < width:
        s = torch.cat([s, s.new_full((s.shape[0], width - (stop - start)), NEG_INF)], 1)
    return s


def _query_blocks(nq: int, chunk_size: int):
    step = max(1, _SCORE_BYTES // (4 * chunk_size))
    return [(a, min(a + step, nq)) for a in range(0, max(nq, 1), step)]


def _check(metric: str, selector: str) -> None:
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")


def int8_search(
    q_i8: torch.Tensor,
    q_scale: torch.Tensor,
    q_sq: torch.Tensor,
    db_i8: torch.Tensor,
    db_scale: torch.Tensor,
    db_sq: torch.Tensor,
    k: int,
    *,
    metric: str,
    n_valid,
    chunk_size: int,
    selector: str = "exact",
    recall_target: float = DEFAULT_INT8_RECALL_TARGET,
    dead: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked int8 scan with a running top-k; the contract of
    ``ops/distance.exact_search``: (Q, k) float32 values (squared L2 from
    the exact norms, ascending; or inner products, descending) and int32
    ids, -1 / inf in slots no live row fills. ``selector`` ("exact" or
    "approx") and ``recall_target`` are taken for the JAX signature:
    selection is exact."""
    _check(metric, selector)
    n = db_i8.shape[0]
    nq = q_i8.shape[0]
    k_eff = min(k, n)
    nv = int(n_valid)
    kc = min(k_eff, chunk_size)
    out_v, out_i = [], []
    for a, b in _query_blocks(nq, chunk_size):
        best_v = torch.full((b - a, k_eff), NEG_INF, device=db_i8.device)
        best_i = torch.full((b - a, k_eff), -1, dtype=torch.int32, device=db_i8.device)
        for start in range(0, n, chunk_size):
            stop = min(start + chunk_size, n)
            s = _chunk_scores(q_i8[a:b], q_scale[a:b], db_i8, db_scale, db_sq,
                              start, stop, nv, dead, metric, kc)
            cv, cp = small_topk(s, kc)
            best_v, best_i = merge_topk(best_v, best_i, cv, cp + start, k_eff)
        out_v.append(best_v)
        out_i.append(best_i)
    return finish_topk(torch.cat(out_v), torch.cat(out_i), q_sq, k, metric)


def int8_rerank_search(
    q: torch.Tensor,
    q_i8: torch.Tensor,
    q_scale: torch.Tensor,
    q_sq: torch.Tensor,
    db_i8: torch.Tensor,
    db_scale: torch.Tensor,
    db_sq: torch.Tensor,
    shadow: Optional[torch.Tensor],
    k: int,
    *,
    metric: str,
    n_valid,
    chunk_size: int,
    cand_per_chunk: int,
    recall_target: float = 0.99,
    dead: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage retrieve-then-rerank over int8 storage.

    Stage 1 scans the codes chunk by chunk and keeps each chunk's top
    ``cand_per_chunk`` with no cross-chunk merge (chunk-major candidate
    lists; ids past the rows of a short last chunk are invalid). Stage 2
    re-checks each candidate (at or past ``n_valid``, or ``dead``: never
    returned), gathers its row from the bf16 ``shadow`` (or the dequantized
    codes without one) and re-scores it exactly against the float32 query
    with the row's OWN norm |x̂|^2: mixing the exact stored norm with the
    shadow's dots leaves a 2 q.(x - x̂) error that scrambles near-tied
    neighbours. Returns the contract of ``int8_search``."""
    _check(metric, "exact")
    n = db_i8.shape[0]
    nq = q_i8.shape[0]
    nv = int(n_valid)
    kc = min(cand_per_chunk, chunk_size)
    out_v, out_i = [], []
    for a, b in _query_blocks(nq, chunk_size):
        cand = []
        for start in range(0, n, chunk_size):
            stop = min(start + chunk_size, n)
            s = _chunk_scores(q_i8[a:b], q_scale[a:b], db_i8, db_scale, db_sq,
                              start, stop, nv, dead, metric, kc)
            cand.append(small_topk(s, kc)[1] + start)
        cand_ids = torch.cat(cand, 1)                              # (qb, C)
        valid = cand_ids < nv
        if dead is not None:
            valid &= ~dead[cand_ids.clamp_max(n - 1).long()]
        safe = torch.where(valid, cand_ids, torch.zeros_like(cand_ids)).long()
        if shadow is not None:
            rows = shadow[safe].float()                            # (qb, C, D)
        else:
            rows = db_i8[safe].float() * db_scale[safe][..., None]
        dots = torch.einsum("qd,qcd->qc", q[a:b].float(), rows)
        sc = 2.0 * dots - (rows * rows).sum(-1) if metric == "L2" else dots
        sc = sc.masked_fill(~valid, NEG_INF)
        best_v, pos = small_topk(sc, min(k, sc.shape[1]))
        out_v.append(best_v)
        out_i.append(torch.gather(cand_ids, 1, pos.long()))
    return finish_topk(torch.cat(out_v), torch.cat(out_i), q_sq, k, metric)
