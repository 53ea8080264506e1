"""Product quantization (PQ): codebook training, encode / decode, ADC scan.

Counterpart of ``rag_faiss_embedding_tpu/ops/pq.py`` with the same
functions and contracts:

- ``train_pq``: batched Lloyd over all M subspaces at once, with the
  empty-codeword reseed (a random training point plus 1e-4 jitter). The
  update is a segment sum over points sorted by (subspace, codeword), as in
  ``ops/kmeans``: it repeats bit for bit on the card, where float atomics
  would not. Draws come from a ``torch.Generator`` seeded by ``seed``, so
  the codebooks differ from JAX's; they are compared by their metrics.
- ``train_opq``: OPQ's alternation of Lloyd and the Procrustes rotation
  (``torch.linalg.svd``).
- ``pq_encode``: chunked, one subspace at a time, so no (M, chunk, ksub)
  tensor is ever made; returns the exact reconstruction norms ||x̂||^2.
- ``pq_decode``: the float32 decode, through ``ops/pq_decode.decode``: its
  plain gather on a CPU tensor, the kernel's float32 form on the card (the
  same bits).
- ``pq_search``: chunked ADC: each chunk is decode -> one float32 product ->
  running top-k (``merge_topk``, ties to the lowest index). With
  ``compute_dtype="bf16"`` codebooks and queries are rounded to bfloat16 and
  their products taken in float32 (JAX's ``preferred_element_type``); with
  ``"f32"`` everything is float32. ``pq_w`` truthy decodes through the
  kernel wrapper (the kernel on the card), else through the plain gather.
  Only the exact selector is ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.logging import get_logger

from .distance import NEG_INF, as_tensor, finish_topk, merge_topk, small_topk, sqnorms
from .pq_decode import decode, decode_reference

logger = get_logger(__name__)

# elements of one (M, chunk, ksub) score block in Lloyd's assignment
_ASSIGN_BLOCK = 1 << 26


# ---------------------------------------------------------------- training
def _lloyd_batched(x: torch.Tensor, cents: torch.Tensor, gen: torch.Generator,
                   n_iters: int) -> torch.Tensor:
    """Lloyd iterations for all subspaces at once: ``x`` (M, n, dsub) and
    ``cents`` (M, ksub, dsub) float32. Assignment ties go to the lowest
    codeword (``argmax``)."""
    m, n, dsub = x.shape
    ksub = cents.shape[1]
    dev = x.device
    chunk = max(1, _ASSIGN_BLOCK // (m * ksub))
    offs = (torch.arange(m, device=dev) * ksub)[:, None]
    flat = x.reshape(m * n, dsub)
    for _ in range(n_iters):
        c_sq = (cents * cents).sum(-1)                          # (M, ksub)
        assign = torch.empty((m, n), dtype=torch.long, device=dev)
        for s in range(0, n, chunk):
            dots = torch.bmm(x[:, s:s + chunk], cents.transpose(1, 2))
            assign[:, s:s + chunk] = torch.argmax(2.0 * dots - c_sq[:, None, :], dim=-1)
        keys = (assign + offs).reshape(-1)
        order = torch.sort(keys, stable=True).indices
        counts = torch.bincount(keys, minlength=m * ksub)
        sums = torch.segment_reduce(flat[order], "sum", lengths=counts, axis=0)
        counts = counts.view(m, ksub, 1)
        new = sums.view(m, ksub, dsub) / counts.clamp_min(1).float()
        ridx = torch.randint(0, n, (m, ksub), generator=gen, device=dev)
        jitter = 1e-4 * torch.randn((m, ksub, dsub), generator=gen, device=dev)
        reseed = torch.gather(x, 1, ridx[..., None].expand(m, ksub, dsub)) + jitter
        cents = torch.where(counts > 0, new, reseed)
    return cents


def train_pq(x, m: int, ksub: int = 256, n_iters: int = 25, seed: int = 0,
             train_sample: int = 65536) -> torch.Tensor:
    """Train per-subspace codebooks on (N, D) rows, D divisible by ``m``,
    from a seeded subsample of up to ``train_sample`` rows. Returns
    (M, ksub, dsub) float32 on the rows' device (ksub shrinks to N when
    there are fewer rows)."""
    x = as_tensor(x, dtype=torch.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    if n == 0:
        raise ValueError("cannot train PQ on an empty set")
    ksub = min(ksub, n)
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    if n > train_sample:
        x = x[torch.randperm(n, generator=gen, device=x.device)[:train_sample]]
        n = train_sample
    dsub = d // m
    xs = x.reshape(n, m, dsub).transpose(0, 1).contiguous()     # (M, n, dsub)
    init = torch.randperm(n, generator=gen, device=x.device)[:ksub]
    cents = _lloyd_batched(xs, xs[:, init, :], gen, n_iters)
    logger.debug("trained PQ codebooks M=%d ksub=%d dsub=%d on %d rows", m, ksub, dsub, n)
    return cents


def train_opq(x, m: int, ksub: int = 256, n_iters: int = 25, outer_iters: int = 10,
              seed: int = 0, train_sample: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ: an orthogonal rotation R that lowers the PQ reconstruction
    error, alternating Lloyd on X @ R with the Procrustes step R = U V^T of
    SVD(X^T X̂). Returns (R (D, D) float32, codebooks trained on the rotated
    rows); encode ``x @ R`` and rotate queries the same way."""
    x = as_tensor(x, dtype=torch.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    if n > train_sample:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        x = x[torch.randperm(n, generator=gen, device=x.device)[:train_sample]]
    r = torch.eye(d, device=x.device)
    cb = None
    for it in range(outer_iters):
        xr = x @ r
        # cheap inner Lloyd while alternating; the full count on the last pass
        inner = n_iters if it == outer_iters - 1 else max(4, n_iters // 4)
        cb = train_pq(xr, m, ksub=ksub, n_iters=inner, seed=seed + it,
                      train_sample=train_sample)
        if it == outer_iters - 1:
            break
        codes, _ = pq_encode(cb, xr)
        u, _, vt = torch.linalg.svd(x.T @ pq_decode(cb, codes), full_matrices=False)
        r = u @ vt
    return r, cb


# ----------------------------------------------------------- encode/decode
def pq_encode(codebooks: torch.Tensor, x, chunk_size: int = 131072
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode rows to (N, M) uint8 codes and the exact (N,) float32
    reconstruction norms ||x̂||^2 (the ADC identity needs those, not
    ||x||^2). One (chunk, ksub) score block at a time."""
    x = as_tensor(x, codebooks.device, torch.float32)
    m, ksub, dsub = codebooks.shape
    n = x.shape[0]
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    sq = torch.empty((n,), dtype=torch.float32, device=x.device)
    c_sq = (codebooks * codebooks).sum(-1)                      # (M, ksub)
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        xs = x[start:stop].reshape(-1, m, dsub)
        for j in range(m):
            dots = xs[:, j] @ codebooks[j].T                    # (c, ksub)
            codes[start:stop, j] = torch.argmax(2.0 * dots - c_sq[j][None, :], dim=1)
        sq[start:stop] = sqnorms(pq_decode(codebooks, codes[start:stop]))
    return codes, sq


def pq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 reconstructions of (N, M) codes."""
    return decode(codebooks.float(), codes)


# ------------------------------------------------------------------ search
def pq_search(
    q,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    rec_sq: torch.Tensor,
    k: int,
    *,
    metric: str = "L2",
    n_valid: int = 0,
    chunk_size: int = 524288,
    dead: Optional[torch.Tensor] = None,
    compute_dtype: str = "bf16",
    pq_w: Optional[bool] = None,
    interpret: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked ADC scan over the first ``n_valid`` of (N, M) ``codes``; the
    contract of ``ops/distance.exact_search`` with distances TO THE
    RECONSTRUCTION (L2 ascending, IP descending), ``dead`` rows masked,
    k > N padded with -1 / inf. Returns (values, ids) on the codes'
    device. ``pq_w`` decodes through the kernel's wrapper (``pq_decode.
    decode``), else the plain decode; the port has no interpret mode, so
    ``interpret=True`` takes the plain decode too."""
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    if compute_dtype not in ("bf16", "f32"):
        raise ValueError("compute_dtype must be 'bf16' or 'f32'")
    dev = codes.device
    n = codes.shape[0]
    qf = as_tensor(q, dev, torch.float32)
    nq = qf.shape[0]
    k_eff = min(k, max(n, 1))
    if compute_dtype == "bf16":
        cb_s, qs = codebooks.to(torch.bfloat16), qf.to(torch.bfloat16).float()
    else:
        cb_s, qs = codebooks.float(), qf
    dec_fn = decode if pq_w and not interpret else decode_reference
    n_valid = int(n_valid)
    best_v = torch.full((nq, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k_eff), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        dots = qs @ dec_fn(cb_s, codes[start:stop]).float().T
        scores = 2.0 * dots - rec_sq[None, start:stop] if metric == "L2" else dots
        live = torch.arange(start, stop, device=dev) < n_valid
        if dead is not None:
            live = live & ~dead[start:stop]
        scores = scores.masked_fill(~live[None, :], NEG_INF)
        cv, cp = small_topk(scores, min(k_eff, stop - start))
        best_v, best_i = merge_topk(best_v, best_i, cv, cp + start, k_eff)
    return finish_topk(best_v, best_i, qf, k, metric)
