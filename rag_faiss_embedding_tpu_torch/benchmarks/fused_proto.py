"""The fused union-block top-k prototype of the IVF search, on the card.

Counterpart of ``benchmarks/pallas_fused_proto.py``: ``search`` is its
``search_pallas`` over this package's ``IVFFlatIndex`` state, with the cell
top-k in ``ops/fused_proto.block_topk`` (K5, ``csrc/fused_proto.cu``):

1. coarse L2 scores ``2 q.c - ||c||^2`` in float32 (queries cast to the
   centroids' storage dtype), and a stable sort of the queries by their
   top-1 list;
2. per chunk of ``qc`` sorted queries, the maxima of the relative coarse
   scores, the top ``ucap`` lists (ties to the lower list id), sorted;
3. ``block_topk`` over cells of ``bb`` of those lists: the top ``kp``
   distinct ids per (query, cell);
4. the exact top ``k`` of a query's ``(ucap / bb) * kp`` candidates, ties to
   the lower position (``lax.top_k``), un-permuted; distances
   ``max(||q||^2 - s, 0)``, inf / -1 where a slot is empty.

Like the prototype, the search reads only the block-padded lists: the
index's exact tier (rows spilled past the rescue limit) and its pending tier
are not searched.

Run on one card (``python -m
rag_faiss_embedding_tpu_torch.benchmarks.fused_proto``): the script's own
shape, 1,048,576 x 384 rows from 8,192 Gaussian modes (row = mode + 0.7
noise; queries = the first rows + 0.3 noise), made on the card from a seeded
generator, in ``IVFFlatIndex(384, nlist=8192, dtype="bfloat16",
train_iters=10, balance="reassign")``; UCAP = QC = 256, BB 16, KP 10, k 10,
8 batches of 1,024 queries. It prints JSON lines: the build, recall@10 of
the first batch against the exact float32 top-10, then ms per batch and
queries per second (CUDA events), each with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Tuple

import torch

from ..ops.distance import NEG_INF
from ..ops.fused_proto import block_topk

N_DB, DIM, K, Q_BATCH, REPS = 1_048_576, 384, 10, 1024, 8
N_MODES, NLIST = 8192, 8192
UCAP = QC = 256
KP = 10
BB = 16  # union blocks per cell
SEED = 0


def _top_low(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, ties to the lower position
    (``lax.top_k``; ``torch.topk`` does not promise it)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def cell_args(q, index, *, ucap: int = UCAP, qc: int = QC, bb: int = BB):
    """Steps 1-2 of ``search``: the query permutation, the queries' squared
    norms, and the keyword arguments of its ``block_topk`` call (``qs``,
    ``u_all``, ``codes3``, ``sq2``, ``ids2``, ``bb``)."""
    if index.pq_m or index.metric != "L2" or not index._window:
        raise ValueError("the prototype searches a built dense L2 IVFFlatIndex")
    nlist, window, d = index.nlist, index._window, index.dim
    q = torch.as_tensor(q, device=index.device)
    nq = q.shape[0]
    if nq % qc:
        raise ValueError(f"Q={nq} must be a multiple of qc={qc}")
    if ucap % bb:
        raise ValueError(f"ucap={ucap} must be a multiple of bb={bb}")
    if ucap > nlist:
        raise ValueError(f"ucap={ucap} exceeds nlist={nlist}")
    qf = q.float()
    cent = index._cent_store
    cdots = qf.to(cent.dtype).float() @ cent.float().T
    cscores = 2.0 * cdots - index._cent_sq[None, :]
    rel = cscores - cscores.max(dim=1, keepdim=True).values
    perm = torch.sort(torch.argmax(cscores, dim=1), stable=True).indices
    qp, rel_p = qf[perm], rel[perm]
    steps = nq // qc
    chunk_rel = rel_p.view(steps, qc, nlist).max(dim=1).values
    u_all = torch.sort(_top_low(chunk_rel, ucap)[1].to(torch.int32), dim=1).values
    args = dict(qs=qp.to(torch.bfloat16).view(steps, qc, d), u_all=u_all,
                codes3=index._sorted_vecs.view(nlist + 1, window, d),
                sq2=index._sorted_sq.view(nlist + 1, window),
                ids2=index._sorted_ids.view(nlist + 1, window), bb=bb)
    return perm, (qf * qf).sum(-1), args


def search(q, index, *, ucap: int = UCAP, qc: int = QC, bb: int = BB, kp: int = KP,
           k: int = K, cell_topk=block_topk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prototype's search over ``index`` (a built dense L2
    ``IVFFlatIndex``): (Q, k) float32 squared L2 distances and int32 ids,
    inf / -1 where fewer than ``k`` candidates exist. ``cell_topk`` is the
    cell top-k (``ops.fused_proto.block_topk_reference`` runs the plain
    version on a CUDA index)."""
    perm, q_sq, args = cell_args(q, index, ucap=ucap, qc=qc, bb=bb)
    out_v, out_i = cell_topk(**args, kp=kp)
    nq, nb = perm.shape[0], ucap // bb
    cv = out_v.permute(0, 2, 1, 3).reshape(nq, nb * kp)
    ci = out_i.permute(0, 2, 1, 3).reshape(nq, nb * kp)
    bv, pos = _top_low(cv, k)
    bi = torch.gather(ci, 1, pos)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nq, device=perm.device)
    bv, bi = bv[inv], bi[inv]
    ok = bv > NEG_INF
    vals = torch.where(ok, torch.clamp_min(q_sq[:, None] - bv, 0.0), float("inf"))
    return vals, torch.where(ok, bi, -1).to(torch.int32)


def recall_at(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean share of each row's true top-k found in ``ids``."""
    hit = (ids[:, :, None].long() == truth[:, None, :].long()).any(-1)
    return float(hit.float().sum(1).mean() / truth.shape[1])


def make_data(*, device, seed: int = SEED, n: int = N_DB, dim: int = DIM,
              n_modes: int = N_MODES, batches: int = REPS, q_batch: int = Q_BATCH):
    """The script's rows (n, dim) and query batches (batches, q_batch, dim),
    float32, made on ``device`` from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(n_modes, dim, generator=g, device=device)
    db = centers[torch.randint(0, n_modes, (n,), generator=g, device=device)]
    db += 0.7 * torch.randn(n, dim, generator=g, device=device)
    q = db[:batches * q_batch] + 0.3 * torch.randn(batches * q_batch, dim, generator=g,
                                                   device=device)
    return db, q.view(batches, q_batch, dim)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    from ..index import FlatIndex, IVFFlatIndex

    if not torch.cuda.is_available():
        raise SystemExit("fused_proto: no CUDA device; this benchmark runs on a GPU")
    dev = torch.device("cuda")
    smi = card()
    db, q_all = make_data(device=dev)
    t0 = time.perf_counter()
    idx = IVFFlatIndex(DIM, nlist=NLIST, dtype="bfloat16", train_iters=10,
                       balance="reassign", device=dev)
    idx.build(db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    flat = FlatIndex(DIM, capacity=N_DB, device=dev)
    flat.add(db)
    _, truth = flat.search(q_all[0], K)  # exact float32 top-10
    del flat, db
    torch.cuda.empty_cache()
    print(json.dumps({"probe": "build", "build_s": build_s, "window": idx._window,
                      "card": smi}), flush=True)
    _, ids = search(q_all[0], idx)
    print(json.dumps({"probe": "fused_proto_recall", "recall": recall_at(ids, truth),
                      "card": smi}), flush=True)

    def many():
        for b in range(REPS):
            search(q_all[b], idx)

    many()  # warm-up
    best = None
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        many()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / REPS
        best = ms if best is None else min(best, ms)
    print(json.dumps({"probe": "fused_proto_qps", "ms": best, "qps": Q_BATCH / best * 1e3,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
