"""Fused batched IVF search: coarse stage, chunk unions, union scan, spill.

Counterpart of ``rag_faiss_embedding_tpu/ops/ivf_scan.py`` for dense float32
/ bfloat16 / int8 storage and PQ codes, with the same steps and dispatch:

1. coarse: one (Nq, nlist) float32 product for the whole batch (queries cast
   to the centroids' dtype first, as JAX does);
2. queries sorted by their best list (``minrank``: top-1 probe; ``chunkmax``:
   argmax), padded with replicas of the last one to a multiple of ``qc``;
3. per chunk of ``qc`` queries, a union of ``union_cap`` list ids:
   ``minrank`` compacts the chunk's probes by min probe rank
   (``_select_union``), ``chunkmax`` (nlist > 2048) ranks lists by the max
   normalised coarse score any member query gives;
4. the chunk stage: ``backend="pallas"`` runs the union-scan kernel
   (``ops/union_scan.py``; its plain version on a CPU index) and decodes its
   packed candidates; ``backend="xla"`` is the plain chunk body
   (``_chunk_body``), a Python loop over chunks where JAX uses scan/vmap:
   int8 storage scores with the int8 product (``ops/quantize.int8_dots``,
   ``torch._int_mm`` on the card) of the per-batch quantized queries, and
   with a dense bf16 ``shadow`` re-scores its top ``max(k, rerank_depth)``
   exactly (the row's own norm) before the final top k; int8 and shadow
   configurations never take the union-scan kernel, as in JAX;
   PQ storage (``pq`` given) always takes the PQ chunk body
   (``_chunk_body_pq``): residual codes decoded (``pq_w``: through the
   decode kernel's wrapper, else the plain gather), one product per union
   segment plus the coarse stage's q.centroid shift, a running top
   ``k_cand``, and the optional compact refine shadow;
5. the spill tier (window overflow + streaming adds) is scored once for the
   whole batch (quantized, with no shadow, for int8) and merged exactly, then
   scores become distances.

Where JAX selects with ``lax.approx_max_k`` (the chunk bodies; the coarse
stage past 2,048 lists), the port selects exactly: off the TPU
``approx_max_k`` is an exact top-k, so the CPU parity tests compare like
with like. Selection ties go to the lowest index throughout (stable sorts /
``small_topk``).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from .distance import NEG_INF, merge_topk
from .distance import stable_topk as _topk
from .pq_decode import decode as pq_decode_kernel, decode_reference as pq_decode_plain
from .quantize import int8_dots, quantize_rows
from .union_scan import (
    decode_selected, decode_topk, kernel_eligible, pick_bb, union_scan,
)

_STEP_BYTES_BUDGET = 1 << 30
_COARSE_APPROX_MIN_NLIST = 2048
_RANK_INF = 1 << 30
logger = logging.getLogger(__name__)


def default_union_cap(nlist: int, nprobe: int) -> int:
    """Union slots per chunk: at least every list of a small index, and
    16 x nprobe (>= 64) for a large one."""
    return min(nlist, max(64, 16 * nprobe))


def pick_query_chunk(nprobe: int, window: int, dim: int, code_bytes: int,
                     n_queries: int, union_cap: Optional[int] = None,
                     nlist: Optional[int] = None) -> int:
    """Query chunk size: the union budget capped at 256, halved while the
    per-step intermediates (gathered rows + score matrix) exceed the step
    budget, and no larger than the batch (>= 8)."""
    if union_cap is None:
        union_cap = default_union_cap(nlist or (1 << 30), nprobe)
    rows = union_cap * window
    qc = max(16, min(256, union_cap))
    while qc > 8:
        if rows * dim * code_bytes + qc * rows * 4 <= _STEP_BYTES_BUDGET:
            break
        qc //= 2
    return max(8, min(qc, max(8, n_queries)))


def query_chunk_recall_safe(qc: int, union_cap: int) -> bool:
    """Whether a chunk can be served by its union: qc <= union_cap."""
    return qc <= union_cap


def resolve_fused_dispatch(*, nq: int, dim: int, nlist: int, window: int,
                           code_bytes: int, quantized: bool, has_shadow: bool,
                           has_pq: bool, has_filter: bool, nprobe: int,
                           union_cap: Optional[int] = None,
                           qc: Optional[int] = None, backend: str = "auto",
                           platform: str = "cuda") -> dict:
    """The (nprobe, union_cap, qc, backend, interpret) a fused search will
    dispatch with, without running it. The JAX package's rule, with
    ``platform == "cuda"`` where it has ``"tpu"``: on a CUDA index ``auto``
    picks the union-scan kernel when eligible, padding qc to >= 16 (which
    changes which queries share a union). A filter routes to the plain chunk
    body. ``interpret`` is True where the kernel route runs its plain version
    (``backend="pallas"`` on a CPU index)."""
    nprobe = min(nprobe, nlist)
    if union_cap is None:
        union_cap = default_union_cap(nlist, nprobe)
    if qc is None:
        if has_pq:
            qc = max(16, min(256, union_cap))
        else:
            qc = pick_query_chunk(nprobe, window, dim, code_bytes, nq,
                                  union_cap=union_cap)
    elif not query_chunk_recall_safe(qc, union_cap):
        logger.warning(
            "query chunk %d exceeds union_cap %d: the chunk union cannot "
            "serve every query's probe lists and recall will collapse", qc,
            union_cap)
    qc = min(qc, max(8, nq))
    interpret = False
    if (has_filter or has_pq) and backend == "auto":
        backend = "xla"
    if backend != "xla":
        qc_kernel = max(qc, 16)
        eligible = kernel_eligible(
            platform=platform, quantized=quantized, window=window, dim=dim,
            qc=qc_kernel, shadow=has_shadow or None,
            interpret=backend == "pallas")
        if eligible:
            qc = qc_kernel
        if backend == "pallas" and not eligible:
            raise ValueError(
                "pallas backend needs full-precision storage, no shadow, "
                f"window/dim multiples of 128, qc >= 16 (got window={window} "
                f"dim={dim} qc={qc} quantized={quantized})")
        backend = "pallas" if eligible else "xla"
        interpret = backend == "pallas" and platform != "cuda"
    return {"nprobe": nprobe, "union_cap": union_cap, "qc": qc,
            "backend": backend, "interpret": interpret}


def _pq_union_segments(u_n: int, window: int, m_bytes: int, d: int, qc: int) -> int:
    """Segments the PQ chunk stage streams its union in, so a step's live
    bytes (gathered codes, ids and norms, decoded rows, the score matrix)
    stay under ``_STEP_BYTES_BUDGET``; equal segments. JAX's rule."""
    bytes_per_list = window * (m_bytes + 8 + 4 * d + 4 * qc)
    useg = max(1, -(-int(u_n) * bytes_per_list // _STEP_BYTES_BUDGET))
    if useg > 1:
        useg = -(-u_n // (-(-u_n // useg)))
    return int(useg)


def _select_union(probes: torch.Tensor, nlist: int, union_cap: int) -> torch.Tensor:
    """Compact each chunk's (qc, nprobe) probe lists to ``union_cap`` unique
    list ids ranked by min probe rank; unused slots hold the sentinel
    ``nlist``; sorted ascending. ``probes`` is (steps, qc, nprobe)."""
    steps, qcn, nprobe = probes.shape
    ids = probes.reshape(steps, -1).long()
    ranks = torch.arange(nprobe, device=probes.device).repeat(qcn)[None].expand(steps, -1)
    # primary id, secondary rank: stable sort by rank, then by id
    o1 = torch.sort(ranks, dim=1, stable=True).indices
    ids1, ranks1 = ids.gather(1, o1), ranks.gather(1, o1)
    o2 = torch.sort(ids1, dim=1, stable=True).indices
    ids_s, ranks_s = ids1.gather(1, o2), ranks1.gather(1, o2)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    key = torch.where(first, ranks_s, torch.full_like(ranks_s, _RANK_INF))
    take = min(union_cap, ids_s.shape[1])
    ord2 = torch.sort(key, dim=1, stable=True).indices[:, :take]
    u = torch.where(key.gather(1, ord2) < _RANK_INF, ids_s.gather(1, ord2),
                    torch.full_like(ord2, nlist))
    return torch.sort(u, dim=1).values.to(torch.int32)


def _live_rows(rid, filt):
    """Searchable rows: id >= 0 and, with a filter, allowed by it."""
    live = rid >= 0
    if filt is not None:
        live = live & filt[rid.clamp_min(0).long()]
    return live


def _score_rows(qf, q_i8, q_scale, rows, rscale, rsq, rid, metric, filt=None):
    """Exact internal scores (higher better) of queries vs rows: int8 codes
    (``rscale`` given) by the int8 product of the quantized queries, scaled
    as JAX does; otherwise queries cast to the storage dtype, products in
    float32."""
    if rscale is not None:
        dots = int8_dots(q_i8, rows).float() * q_scale[:, None] * rscale[None, :]
    else:
        dots = qf.to(rows.dtype).float() @ rows.float().T
    scores = 2.0 * dots - rsq[None, :] if metric == "L2" else dots
    return scores.masked_fill(~_live_rows(rid, filt)[None, :], NEG_INF)


def _chunk_body(q, q_i8, q_scale, u, codes, scales, sorted_sq, sorted_ids, shadow, *,
                k: int, window: int, metric: str, rerank_depth: int, filt=None):
    """Search one query chunk against its union blocks (the plain chunk
    body). Returns (values, ids) on the internal scale. The top
    ``k_cand = max(k, rerank_depth)`` is selected; without a shadow the
    exact top k of it is the exact top k. With the slot-laid bf16
    ``shadow`` (int8 storage) the candidates are re-scored exactly against
    their shadow rows with the rows' own norms, re-masked (a dead or
    filtered row never comes back), and the top k kept."""
    d = q.shape[1]
    ul = u.long()
    rows = codes.view(-1, window, d)[ul].reshape(-1, d)
    rid = sorted_ids.view(-1, window)[ul].reshape(-1)
    rsq = sorted_sq.view(-1, window)[ul].reshape(-1)
    rscale = scales.view(-1, window)[ul].reshape(-1) if scales is not None else None
    scores = _score_rows(q, q_i8, q_scale, rows, rscale, rsq, rid, metric, filt=filt)
    k_cand = min(max(k, rerank_depth), scores.shape[1])
    if shadow is None:
        best_v, pos = _topk(scores, min(k, k_cand))
        return best_v, rid[pos.long()]
    best_v, pos = _topk(scores, k_cand)
    pos = pos.long()
    best_i = rid[pos]
    slot = ul[pos // window] * window + pos % window            # (qc, k_cand)
    srows = shadow[slot].float()                                # (qc, kc, D)
    dots = torch.einsum("qd,qkd->qk", q, srows)
    # the shadow row's own norm, not the exact stored one (see _chunk_body_pq)
    sc = 2.0 * dots - (srows * srows).sum(-1) if metric == "L2" else dots
    sc = sc.masked_fill(~_live_rows(best_i, filt), NEG_INF)
    best_v, sel = _topk(sc, min(k, k_cand))
    return best_v, best_i.gather(1, sel.long())


def _chunk_body_pq(q, qr, u, cdu, codes, sorted_sq, sorted_ids, pq_cb, *, k: int,
                   window: int, metric: str, rerank_depth: int, filt=None,
                   pq_w: bool = False, shadow=None, useg: int = 1):
    """PQ chunk stage for one query chunk: ``q`` (qc, D) float32 queries,
    ``qr`` the same rotated by OPQ (== q without), ``u`` (U,) union list
    ids, ``cdu`` (qc, U) raw q.centroid dots of those lists. Residual codes
    decode (in ``pq_cb``'s dtype) and score as
    ``q.x̂ = q.c_list + qr.r̂``; L2 adds the exact stored ||c + r̂||^2.
    The top ``k_cand = max(k, rerank_depth)`` per query is kept (over
    ``useg`` union segments with a running merge when asked), then either
    trimmed to k or, with ``shadow`` = (rows, scales | None, exact norms,
    slot -> row map), re-scored exactly against the dequantized shadow rows
    with their own norms and re-masked (a dead or filtered row never comes
    back). Returns (values, ids) on the internal scale."""
    m = codes.shape[1]
    qc_n = q.shape[0]
    u_count = u.shape[0]
    codes3 = codes.view(-1, window, m)
    ids2 = sorted_ids.view(-1, window)
    sq2 = sorted_sq.view(-1, window)
    sent = codes3.shape[0] - 1          # the sentinel list (rows carry id -1)
    decode = pq_decode_kernel if pq_w else pq_decode_plain
    lane = torch.arange(window, dtype=torch.long, device=q.device)

    def seg_scores(u_s, cdu_s):
        ul = u_s.long()
        rows = codes3[ul].reshape(-1, m)
        rid = ids2[ul].reshape(-1)
        rsq = sq2[ul].reshape(-1)
        dec = decode(pq_cb, rows)                               # (S*window, D)
        dots = qr.to(dec.dtype).float() @ dec.float().T
        dots = dots + cdu_s.repeat_interleave(window, dim=1)
        scores = 2.0 * dots - rsq[None, :] if metric == "L2" else dots
        scores = scores.masked_fill(~_live_rows(rid, filt)[None, :], NEG_INF)
        slots = (ul[:, None] * window + lane[None, :]).reshape(-1)
        return scores, rid, slots

    k_cand = min(max(k, rerank_depth), u_count * window)
    if useg <= 1:
        scores, rid, slots = seg_scores(u, cdu)
        best_v, pos = _topk(scores, k_cand)
        best_i = rid[pos.long()]
        best_slot = slots[pos.long()]
    else:
        # stream the union in segments with a running top-k_cand: the step's
        # memory is one segment's, each union row is still decoded once
        seg = -(-u_count // useg)
        pad = useg * seg - u_count
        if pad:
            u = torch.cat([u, u.new_full((pad,), sent)])
            cdu = torch.cat([cdu, cdu.new_zeros((qc_n, pad))], 1)
        kc_seg = min(k_cand, seg * window)
        best_v = torch.full((qc_n, k_cand), NEG_INF, device=q.device)
        best_slot = torch.zeros((qc_n, k_cand), dtype=torch.long, device=q.device)
        for s in range(useg):
            scores, _, slots = seg_scores(u[s * seg:(s + 1) * seg],
                                          cdu[:, s * seg:(s + 1) * seg])
            v_s, pos = _topk(scores, kc_seg)
            allv = torch.cat([best_v, v_s], 1)
            alls = torch.cat([best_slot, slots[pos.long()]], 1)
            best_v, sel = _topk(allv, k_cand)
            best_slot = alls.gather(1, sel.long())
        best_i = torch.where(best_v > NEG_INF, sorted_ids[best_slot],
                             torch.full_like(best_slot, -1, dtype=torch.int32))
    if shadow is not None:
        # compact refine shadow: dead slots map to -1, clamped to row 0; the
        # re-mask below drops them (id -1 is never live)
        s_codes, s_scales, _, s_pos = shadow
        cp = s_pos[best_slot].clamp_min(0).long()               # (qc, k_cand)
        srows = s_codes[cp].float()                             # (qc, kc, D)
        if s_scales is not None:
            srows = srows * s_scales[cp][..., None]
        dots = torch.einsum("qd,qkd->qk", q, srows)
        # the dequantized row's own norm, not the exact stored one: the
        # mixed form's 2 q.(x - x̂) error scrambles near-tied neighbours
        ssq = (srows * srows).sum(-1)
        sc = 2.0 * dots - ssq if metric == "L2" else dots
        sc = sc.masked_fill(~_live_rows(best_i, filt), NEG_INF)
        best_v, sel = _topk(sc, min(k, k_cand))
        best_i = best_i.gather(1, sel.long())
    elif k_cand > k:
        best_v, sel = _topk(best_v, k)
        best_i = best_i.gather(1, sel.long())
    return best_v, best_i


def _coarse_union(qf, centroids, cent_sq, *, nprobe: int, metric: str,
                  union_cap: int, qc: int, union_mode: str):
    """Steps 1-3: (perm, permuted + padded queries, u_all (steps, U), the
    raw (Nq, nlist) q.centroid dots)."""
    nlist = centroids.shape[0]
    nq, d = qf.shape
    cdots = qf.to(centroids.dtype).float() @ centroids.float().T
    cscores = 2.0 * cdots - cent_sq[None, :] if metric == "L2" else cdots
    pad = (-nq) % qc
    if union_mode == "chunkmax" and nlist > _COARSE_APPROX_MIN_NLIST:
        rel = cscores - cscores.max(dim=1, keepdim=True).values
        perm = torch.sort(torch.argmax(cscores, dim=1), stable=True).indices
        qp, rel_p = qf[perm], rel[perm]
        if pad:
            qp = torch.cat([qp, qp[-1:].expand(pad, d)])
            rel_p = torch.cat([rel_p, rel_p[-1:].expand(pad, nlist)])
        steps = qp.shape[0] // qc
        chunk_rel = rel_p.view(steps, qc, nlist).max(dim=1).values
        _, u_all = _topk(chunk_rel, min(union_cap, nlist))
        u_all = torch.sort(u_all, dim=1).values.to(torch.int32)
    else:
        _, probes = _topk(cscores, nprobe)
        perm = torch.sort(probes[:, 0], stable=True).indices
        qp, pp = qf[perm], probes[perm]
        if pad:
            qp = torch.cat([qp, qp[-1:].expand(pad, d)])
            pp = torch.cat([pp, pp[-1:].expand(pad, nprobe)])
        steps = qp.shape[0] // qc
        u_all = _select_union(pp.view(steps, qc, nprobe), nlist, union_cap)
    return perm, qp, u_all, cdots


def union_scan_args(qp, u_all, codes, sorted_sq, sorted_ids, *, k: int,
                    window: int, metric: str, pallas_cap: int,
                    pallas_variant: int) -> dict:
    """The union-scan call of the kernel route: the union padded with the
    sentinel to a multiple of ``pick_bb(...)`` (as JAX pads it, which sets
    the packing width), queries cast to the storage dtype, and ``ktop``
    (variant 2 selects in the kernel when k <= min(16, cap*window - 1))."""
    nlist = codes.shape[0] // window - 1
    steps, d = u_all.shape[0], codes.shape[1]
    bb = pick_bb(window, d, codes.element_size(), u_all.shape[1])
    u_pad = (-u_all.shape[1]) % bb
    if u_pad:
        u_all = torch.cat([u_all, u_all.new_full((steps, u_pad), nlist)], 1)
    ktop = k if (pallas_variant == 2
                 and k <= min(16, pallas_cap * window - 1)) else 0
    return dict(qs=qp.to(codes.dtype).view(steps, -1, d), u_all=u_all.contiguous(),
                codes3=codes.view(-1, window, d), sorted_sq=sorted_sq,
                sorted_ids=sorted_ids, window=window, cap=pallas_cap,
                metric=metric, variant=pallas_variant, ktop=ktop)


def fused_ivf_search_math(q, centroids, cent_sq, codes, scales, sorted_sq,
                          sorted_ids, spill=None, shadow=None, filt=None,
                          pq=None, pq_w=None, pq_shadow=None, pq_r=None, *,
                          k: int, nprobe: int, window: int,
                          metric: str, recall_target: float, union_cap: int,
                          qc: int, rerank_depth: int = 16,
                          union_mode: str = "minrank", backend: str = "xla",
                          pallas_cap: int = 2, pallas_variant: int = 1,
                          interpret: bool = False, useg: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch fused search on resolved parameters. Returns (values,
    ids) on the final scale (L2: squared distance ascending; IP: score
    descending). ``recall_target`` and ``interpret`` are taken for the JAX
    signature: selection is exact, and the union scan picks kernel or plain
    version from the device of its tensors.

    PQ storage: ``pq`` (M, ksub, dsub) codebooks in the compute dtype, with
    ``codes`` ((nlist+1)*window, M) uint8 residual codes; ``pq_w`` truthy
    decodes through the kernel wrapper; ``pq_shadow`` the compact refine
    shadow (rows, scales | None, exact norms, slot -> row); ``pq_r`` the OPQ
    rotation (codes encode (x - c) @ R, so q.r̂ = (q @ R).dec); ``useg`` the
    union segments (None: from the step budget).

    int8 storage: ``scales`` the per-slot row scales (the spill tier's in
    ``spill``); ``shadow`` the slot-laid bf16 rerank rows."""
    nq, d = q.shape
    nlist = centroids.shape[0]
    nprobe = min(nprobe, nlist)
    qf = q.float()
    q_sq = (qf * qf).sum(-1)
    perm, qp, u_all, cdots = _coarse_union(
        qf, centroids, cent_sq, nprobe=nprobe, metric=metric,
        union_cap=union_cap, qc=qc, union_mode=union_mode)
    if backend == "pallas":
        if scales is not None or shadow is not None:
            raise ValueError("backend='pallas' requires full-precision storage "
                             "(int8 / shadow configurations run the plain chunk body)")
        if filt is not None:
            raise ValueError("backend='pallas' has no filter operand; filtered "
                             "searches run the plain chunk body")
        if pq is not None:
            raise ValueError("backend='pallas' has no PQ decode stage; PQ "
                             "storage runs the PQ chunk body")
        args = union_scan_args(qp, u_all, codes, sorted_sq, sorted_ids, k=k,
                               window=window, metric=metric,
                               pallas_cap=pallas_cap,
                               pallas_variant=pallas_variant)
        packed = union_scan(**args)
        if args["ktop"]:
            vals_p, ids_p = decode_selected(packed[0], packed[1], args["u_all"],
                                            sorted_ids, window=window, k=k)
        else:
            vals_p, ids_p = decode_topk(packed, args["u_all"], sorted_ids,
                                        window=window, k=k)
    elif pq is not None:
        steps = u_all.shape[0]
        # the residual shift: raw q.c of each chunk's union lists, the
        # sentinel clamped (its rows carry id -1 and are masked anyway)
        cd_p = cdots[perm]
        if steps * qc > nq:
            cd_p = torch.cat([cd_p, cd_p[-1:].expand(steps * qc - nq, nlist)])
        cd_u = cd_p.view(steps, qc, nlist).gather(
            2, u_all.long().clamp_max(nlist - 1)[:, None, :].expand(steps, qc, -1))
        if useg is None:
            useg = _pq_union_segments(u_all.shape[1], window, codes.shape[1], d, qc)
        qr = qp @ pq_r if pq_r is not None else qp
        parts = [_chunk_body_pq(qp[s * qc:(s + 1) * qc], qr[s * qc:(s + 1) * qc],
                                u_all[s], cd_u[s], codes, sorted_sq, sorted_ids, pq,
                                k=k, window=window, metric=metric,
                                rerank_depth=rerank_depth, filt=filt, pq_w=bool(pq_w),
                                shadow=pq_shadow, useg=useg)
                 for s in range(steps)]
        vals_p = torch.cat([p[0] for p in parts])
        ids_p = torch.cat([p[1] for p in parts])
    else:
        # int8 storage: the permuted, padded queries quantized once per batch
        qp_i8, qp_scale = quantize_rows(qp) if scales is not None else (None, None)
        chunk = lambda t, s: t[s * qc:(s + 1) * qc] if t is not None else None
        parts = [_chunk_body(qp[s * qc:(s + 1) * qc], chunk(qp_i8, s), chunk(qp_scale, s),
                             u_all[s], codes, scales, sorted_sq, sorted_ids, shadow,
                             k=k, window=window, metric=metric,
                             rerank_depth=rerank_depth, filt=filt)
                 for s in range(u_all.shape[0])]
        vals_p = torch.cat([p[0] for p in parts])
        ids_p = torch.cat([p[1] for p in parts])
    inv = torch.argsort(perm)
    return _spill_and_finalize(vals_p[:nq][inv], ids_p[:nq][inv], qf, q_sq,
                               spill, metric, k, nq, filt=filt)


def _spill_and_finalize(best_v, best_i, qf, q_sq, spill, metric, k, nq,
                        filt=None):
    """Spill-tier merge (one whole-batch scan, exact top-k, exact merge),
    then internal scores -> FAISS values, padded to k."""
    if spill is not None:
        s_codes, s_scales, s_sq, s_ids = spill
        q_i8, q_scale = quantize_rows(qf) if s_scales is not None else (None, None)
        sscores = _score_rows(qf, q_i8, q_scale, s_codes, s_scales, s_sq, s_ids, metric,
                              filt=filt)
        k_spill = min(k, sscores.shape[1])
        sv, sp = _topk(sscores, k_spill)
        si = s_ids[sp.long()]
        best_v, best_i = merge_topk(best_v, best_i, sv, si,
                                    min(k, best_v.shape[1] + k_spill))
    ok = best_v > NEG_INF
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    if metric == "L2":
        vals = (q_sq[:, None] - best_v).clamp_min(0.0)
        vals = torch.where(ok, vals, torch.full_like(vals, float("inf")))
    else:
        vals = torch.where(ok, best_v, torch.full_like(best_v, float("-inf")))
    if vals.shape[1] < k:
        padk = k - vals.shape[1]
        fill = float("inf") if metric == "L2" else float("-inf")
        vals = torch.cat([vals, vals.new_full((nq, padk), fill)], 1)
        best_i = torch.cat([best_i, best_i.new_full((nq, padk), -1)], 1)
    return vals, best_i.to(torch.int32)


def fused_ivf_search(q, centroids, cent_sq, codes, scales, sorted_sq,
                     sorted_ids, spill=None, shadow=None, filt=None, pq=None,
                     pq_w=None, pq_shadow=None, pq_r=None,
                     *, k: int, nprobe: int, window: int, metric: str = "L2",
                     recall_target: float = 0.995,
                     union_cap: Optional[int] = None,
                     qc: Optional[int] = None, rerank_depth: int = 16,
                     union_mode: str = "minrank", backend: str = "auto",
                     pallas_cap: int = 2, pallas_variant: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused IVF search over a block-padded index. ``backend``:
    "auto" picks the union-scan kernel on an eligible CUDA index (and then
    launches it or raises), else the plain chunk body; "xla" / "pallas"
    force a route ("pallas" on a CPU index runs the kernel's plain
    version). A filter or PQ storage routes "auto" to the plain chunk body;
    PQ's decode takes the kernel wrapper when ``pq_w`` is truthy. int8
    storage (``scales``) and a dense ``shadow`` take the plain chunk body;
    "pallas" raises ``ValueError`` for them.
    Returns (values, indices), (Nq, k)."""
    nq, dim = q.shape
    resolved = resolve_fused_dispatch(
        nq=nq, dim=dim, nlist=centroids.shape[0], window=window,
        code_bytes=codes.element_size(), quantized=scales is not None,
        has_shadow=shadow is not None,
        has_pq=pq is not None, has_filter=filt is not None, nprobe=nprobe,
        union_cap=union_cap, qc=qc, backend=backend,
        platform=codes.device.type)
    useg = (_pq_union_segments(resolved["union_cap"], window, codes.shape[1], dim,
                               resolved["qc"]) if pq is not None else None)
    return fused_ivf_search_math(
        q, centroids, cent_sq, codes, scales, sorted_sq, sorted_ids, spill,
        shadow, filt, pq, pq_w, pq_shadow, pq_r, k=k, nprobe=resolved["nprobe"],
        window=window, metric=metric, recall_target=recall_target,
        union_cap=resolved["union_cap"], qc=resolved["qc"],
        rerank_depth=rerank_depth, union_mode=union_mode,
        backend=resolved["backend"], pallas_cap=pallas_cap,
        pallas_variant=pallas_variant, interpret=resolved["interpret"],
        useg=useg)
