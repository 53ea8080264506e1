"""Lloyd k-means in torch (the IVF coarse quantizer's training).

Counterpart of ``rag_faiss_embedding_tpu/ops/kmeans.py``, with the same
algorithm and arguments:

- assignment is the exact top-1 (or top-c) scan of ``ops/distance``,
  chunked over points, with an optional per-centroid ``bias``;
- the update is a segment sum over rows sorted by list, accumulated in
  float32 (reproducible on the card, unlike float atomics);
- k-means++ seeding on a subsample, donor-split relocation of overfull
  lists, k-means++-style reseeding of empty ones, the capacity ``bias``
  controller (``balance_weight``) and ``spherical`` k-means for IP.

Randomness comes from a ``torch.Generator`` seeded by ``seed``, so the
centroids differ from the JAX package's (its ``jax.random`` draws other
numbers); builds are compared by their metrics, not their centroids. The
host-side parts that use numpy's ``RandomState`` (``_numpy_kmeans``,
``spatial_order``, the relocation picks) are copies that give identical
output on identical input.

The k-means++ loop is sequential: at nlist = 8,192 it is ~8k small launches
on the card.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.logging import get_logger

from .distance import as_tensor, exact_search, small_topk

logger = get_logger(__name__)

_MAX_MOVES = 256  # relocations / reseeds per Lloyd iteration, as in JAX


def _biased_topk_chunk(xc, cents, adj, metric: str, k: int):
    """Top-k centroids by BIASED score (higher better): L2 uses
    2x.c - (|c|^2 + bias), IP x.c - bias. Returns (ids, biased scores)."""
    dots = xc.float() @ cents.float().T
    score = 2.0 * dots - adj[None, :] if metric == "L2" else dots - adj[None, :]
    vals, idx = small_topk(score, k)
    return idx.long(), vals


def _biased_adj(centroids, bias, metric):
    csq = (centroids.float() ** 2).sum(-1)
    return (csq + bias) if metric == "L2" else bias


def assign_topk(x, centroids, c: int, point_chunk: int = 65536,
                metric: str = "L2", bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-c candidate centroids per row: (choices (N, c) int64, values
    (N, c): squared L2 distances ascending or dot products descending,
    unbiased). Chunked over points; ``bias`` (nlist,) adds a per-centroid
    penalty to the effective distance."""
    x = as_tensor(x)
    centroids = as_tensor(centroids, x.device)
    n = x.shape[0]
    c = min(c, centroids.shape[0])
    if n == 0:
        return (torch.zeros((0, c), dtype=torch.long, device=x.device),
                torch.zeros((0, c), device=x.device))
    idx_parts, val_parts = [], []
    if bias is not None:
        bias = as_tensor(bias, x.device, torch.float32)
        adj = _biased_adj(centroids, bias, metric)
        for start in range(0, n, point_chunk):
            xc = x[start:start + point_chunk]
            idx, vals = _biased_topk_chunk(xc, centroids, adj, metric, c)
            if metric == "L2":  # unbiased values, exact_search semantics
                xsq = (xc.float() ** 2).sum(-1)
                vals = (xsq[:, None] - vals - bias[idx]).clamp_min(0.0)
            else:
                vals = vals + bias[idx]
            idx_parts.append(idx)
            val_parts.append(vals)
    else:
        for start in range(0, n, point_chunk):
            vals, idx = exact_search(x[start:start + point_chunk], centroids, c,
                                     metric=metric)
            idx_parts.append(idx.long())
            val_parts.append(vals)
    return torch.cat(idx_parts), torch.cat(val_parts)


def assign(x, centroids, point_chunk: int = 65536, metric: str = "L2",
           bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best centroid per row: (assignments (N,) int64, values (N,))."""
    idx, vals = assign_topk(x, centroids, 1, point_chunk=point_chunk,
                            metric=metric, bias=bias)
    return idx[:, 0], vals[:, 0]


def _update_step(x, assignments, nlist: int):
    """One Lloyd update by segment sum: (centroids, counts). The rows are
    sorted by list and each list summed in order (``segment_reduce``), so a
    build repeats bit for bit on the card, where ``index_add_`` adds floats
    with atomics in a different order each run (same speed there: 1.4 ms at
    524,288 x 384 into 8,192 lists)."""
    order = torch.sort(assignments, stable=True).indices
    counts = torch.bincount(assignments, minlength=nlist)
    sums = torch.segment_reduce(x[order].float(), "sum", lengths=counts, axis=0)
    counts = counts.float()
    return sums / counts.clamp_min(1.0)[:, None], counts


def _kmeanspp_init(x, nlist: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn with probability
    proportional to its squared distance to the nearest chosen one. The
    draws stay on the device (no host sync per step)."""
    n, d = x.shape
    xf = x.float()
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    cents = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
    cents[0] = xf[first[0]]
    d2 = ((xf - xf[first]) ** 2).sum(1)
    for i in range(1, nlist):
        idx = torch.multinomial(d2.clamp_min(1e-30), 1, generator=gen)
        c = xf[idx]                                   # (1, d)
        cents[i] = c[0]
        d2 = torch.minimum(d2, ((xf - c) ** 2).sum(1))
    return cents


def _numpy_kmeans(x: np.ndarray, k: int, n_iters: int = 8,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Small host-side Lloyd (relabeling-scale inputs only): k-means++
    seeding + argmax over a full (n, k) score matrix per iteration; empty
    clusters re-seed from the farthest points. A copy of the JAX package's,
    for identical output."""
    rs = np.random.RandomState(seed)
    n = len(x)
    cents = np.empty((k, x.shape[1]), x.dtype)
    cents[0] = x[rs.randint(n)]
    d2 = ((x - cents[0]) ** 2).sum(1)
    for j in range(1, k):
        p = np.maximum(d2, 1e-30)
        cents[j] = x[rs.choice(n, p=p / p.sum())]
        d2 = np.minimum(d2, ((x - cents[j]) ** 2).sum(1))
    cents = cents.copy()
    assignment = np.zeros(n, np.int64)
    for _ in range(n_iters):
        score = x @ cents.T
        score = 2.0 * score - (cents * cents).sum(1)[None, :]
        assignment = score.argmax(1)
        d2 = (x * x).sum(1) - score[np.arange(n), assignment]
        counts = np.bincount(assignment, minlength=k)
        sums = np.zeros_like(cents)
        np.add.at(sums, assignment, x)
        nonempty = counts > 0
        cents[nonempty] = sums[nonempty] / counts[nonempty, None]
        empty = np.nonzero(~nonempty)[0]
        if len(empty):
            cents[empty] = x[np.argsort(-d2)[: len(empty)]]
    return cents, assignment


def spatial_order(centroids, group: int = 16, seed: int = 0) -> np.ndarray:
    """Permutation that relabels centroids so spatially near ones get nearby
    ids (the fused IVF search sorts queries by top-1 list id, so chunk unions
    stay small only if id adjacency means spatial adjacency). k-means the
    centroids into ~nlist/group super-clusters, order those along the first
    principal axis, lay member ids out contiguously. Host numpy, a copy of
    the JAX package's."""
    if isinstance(centroids, torch.Tensor):
        centroids = centroids.detach().float().cpu().numpy()
    c = np.asarray(centroids, np.float32)
    nlist = len(c)
    if nlist <= group:
        return np.arange(nlist)
    nsuper = max(2, nlist // group)
    super_c, super_a = _numpy_kmeans(c, nsuper, n_iters=8, seed=seed)
    mu = c.mean(0)
    x = c - mu
    v = x[0] + 1e-3  # power iteration for the first principal axis
    for _ in range(8):
        v = x.T @ (x @ v)
        v /= np.linalg.norm(v) + 1e-12
    proj = (super_c - mu) @ v
    super_rank = np.argsort(np.argsort(proj))
    return np.argsort(super_rank[super_a], kind="stable")


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    return c / c.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _relocation_moves(counts_np, assignments, n, nlist, seed, it):
    """Donor-split relocation (the JAX package's host logic, unchanged):
    lists over 2x the target size give member points to the centroids of
    lists under half of it. Returns (donor centroid ids, point ids)."""
    target = n / nlist
    over = np.nonzero(counts_np > 2.0 * target)[0]
    donors_all = np.argsort(counts_np, kind="stable")
    donors = donors_all[counts_np[donors_all] < 0.5 * target]
    donors = donors[~np.isin(donors, over)]
    if not (len(over) and len(donors)):
        return [], []
    over = over[np.argsort(-counts_np[over], kind="stable")]
    need = np.minimum((counts_np[over] / max(target, 1.0)).astype(np.int64), 8)
    a_np = assignments.cpu().numpy()
    order_np = np.argsort(a_np, kind="stable")
    a_sorted_np = a_np[order_np]
    rs = np.random.RandomState((seed * 7919 + it) & 0x7FFFFFFF)
    moves_d, moves_p = [], []
    di = 0
    for b, nd in zip(over, need):
        take = int(min(nd, len(donors) - di, _MAX_MOVES - di))
        if take <= 0:
            break
        lo, hi = np.searchsorted(a_sorted_np, [b, b + 1])
        picks = order_np[rs.choice(hi - lo, size=take, replace=False) + lo]
        moves_d.extend(donors[di:di + take].tolist())
        moves_p.extend(picks.tolist())
        di += take
    return moves_d, moves_p


def train_kmeans(
    x,
    nlist: int,
    n_iters: int = 20,
    seed: int = 0,
    tol: float = 1e-4,
    verbose: bool = False,
    init_sample: int = 64,
    seed_sample: int = 16,
    spherical: bool = False,
    balance_weight: float = 0.0,
    return_bias: bool = False,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, ...]:
    """Lloyd k-means with k-means++ init, on ``x``'s device.

    Returns (centroids (nlist, D) float32, assignments (N,)), plus the final
    per-centroid bias when ``return_bias`` is set. Arguments as in the JAX
    package: ++ seeding on at most ``max(seed_sample * nlist, 4096)`` points
    of an ``init_sample * nlist`` subsample; ``balance_weight > 0`` runs the
    capacity-balanced Lloyd (bias integrated every iteration);
    ``spherical=True`` normalizes centroids and assigns by inner product.
    The last two iterations skip relocation so the partition settles.
    """
    x = as_tensor(x)
    n, d = x.shape
    if nlist > n:
        raise ValueError(f"nlist={nlist} > n={n}")
    metric = "IP" if spherical else "L2"
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    max_init = init_sample * nlist
    t0 = time.perf_counter()
    if n > max_init:
        sample = x[torch.randperm(n, generator=gen, device=x.device)[:max_init]]
    else:
        sample = x
    max_seed = max(seed_sample * nlist, 4096)
    if sample.shape[0] > max_seed:
        if n > max_init:
            seed_set = sample[:max_seed]  # already shuffled
        else:
            seed_set = sample[torch.randperm(n, generator=gen, device=x.device)[:max_seed]]
    else:
        seed_set = sample
    centroids = _kmeanspp_init(seed_set, nlist, gen)
    if spherical:
        centroids = _normalize_rows(centroids)
    if stats is not None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        stats["init_s"] = time.perf_counter() - t0
        stats["assign_s"] = stats["update_s"] = stats["host_s"] = 0.0
        stats["iters"] = 0

    bias = torch.zeros((nlist,), dtype=torch.float32, device=x.device) \
        if balance_weight else None
    target = n / nlist
    prev_obj = float("inf")
    for it in range(n_iters):
        t0 = time.perf_counter()
        assignments, dists = assign(x, centroids, metric=metric, bias=bias)
        obj = float(dists.mean()) * (-1.0 if spherical else 1.0)
        t1 = time.perf_counter()
        new_centroids, counts = _update_step(x, assignments, nlist)
        counts_np = counts.cpu().numpy()
        t2 = time.perf_counter()
        n_tiny = 0
        if it < max(1, n_iters - 2):
            moves_d, moves_p = _relocation_moves(counts_np, assignments, n,
                                                 nlist, seed, it)
            if moves_d:
                n_tiny = len(moves_d)
                dest = torch.as_tensor(moves_d, device=x.device)
                src = torch.as_tensor(moves_p, device=x.device)
                new_centroids[dest] = x[src].float()
        # empty clusters (no donor role possible): k-means++-style reseed
        empty_np = np.nonzero(counts_np < 0.5)[0][:_MAX_MOVES]
        if len(empty_np):
            weight = ((2.0 - 2.0 * dists) if spherical else dists).clamp_min(1e-30)
            picks = torch.multinomial(weight, len(empty_np), replacement=True,
                                      generator=gen)
            new_centroids[torch.as_tensor(empty_np, device=x.device)] = x[picks].float()
            n_tiny += len(empty_np)
        if spherical:
            new_centroids = _normalize_rows(new_centroids)
        centroids = new_centroids
        if bias is not None:
            # leaky integral controller with a clipped step (JAX rationale)
            scale = abs(obj) if metric == "L2" else max(2.0 - 2.0 * obj, 1e-6)
            step = (counts / target - 1.0).clamp(-1.0, 1.0)
            bias = 0.9 * bias + (balance_weight * scale) * step
            bias = bias - bias.min()
        if stats is not None:
            stats["assign_s"] += t1 - t0
            stats["update_s"] += t2 - t1
            stats["host_s"] += time.perf_counter() - t2
            stats["iters"] = it + 1
        if verbose:
            logger.info("kmeans iter %d: obj=%.5f tiny=%d", it, obj, n_tiny)
        if bias is None and n_tiny == 0 and (
            abs(prev_obj - obj) < tol * max(abs(obj), 1e-12)
        ):
            break
        prev_obj = obj
    assignments, _ = assign(x, centroids, metric=metric, bias=bias)
    if return_bias:
        if bias is None:
            bias = torch.zeros((nlist,), dtype=torch.float32, device=x.device)
        return centroids, assignments, bias
    return centroids, assignments
