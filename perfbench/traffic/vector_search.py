"""Closed loop of ``VectorStore.search``: one caller, query vectors only.

Parameters (the cell file's ``params``): ``batch`` query vectors a call,
``batches`` distinct seeded batches cycled in order, ``k``, and
``check_batches``: how many batches' answers the output check judges.

The queries are bench.py's (a row plus 0.3 noise). The encoder, the server
and SQLite are bypassed. A call's latency is its host time, ending in the
host copy of its answers; the rate counts every query answered over the
time from the first call to the last answer.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import data
from ..reference import search as ref


def plan(cell: dict, inputs, seed: int, seconds: float) -> dict:
    t = cell["params"]
    q = inputs.queries(t["batches"] * t["batch"], tag=30).float().cpu().numpy()
    return {"t": t, "seed": seed, "q": q.reshape(t["batches"], t["batch"], -1)}


def prepare(program, p: dict) -> None:
    store = program.store
    for b in range(min(3, len(p["q"]))):  # every call has one shape
        store.search(p["q"][b], p["t"]["k"])
    program.sync()


def instrument(program, spans) -> None:
    spans.wrap(program.store, "search", "vector_store.search",
               lambda a, kw, out: {"q": a[0], "k": a[1]})


def window(program, p: dict, seconds: float, dev) -> dict:
    t, qs = p["t"], p["q"]
    store, k = program.store, t["k"]
    rng = random.Random(data.subseed(p["seed"], 31))
    kept, seen, lat = {}, {}, []
    failed = 0
    with dev.window():
        t0 = time.monotonic_ns()
        end = t0 + int(seconds * 1e9)
        i = 0
        while True:
            b = i % len(qs)
            s = time.monotonic_ns()
            dists, ids = store.search(qs[b], k)
            e = time.monotonic_ns()
            lat.append((e - s) / 1e6)
            failed += sum(len(r) < k for r in ids)
            seen[b] = seen.get(b, 0) + 1
            if rng.random() * seen[b] < 1:  # one answer a batch, drawn from the seed
                kept[b] = (dists, ids)
            i += 1
            if e >= end:
                break
    n = i * qs.shape[1]
    return {"t0": t0, "t1": e, "window_s": (e - t0) / 1e9, "latencies_ms": lat,
            "attempted": n, "failed": failed, "done": {"queries": n}, "kept": kept,
            "calls": i}


def collect(program, p: dict, rec: dict) -> dict:
    return rec["kept"]


def _sample(p: dict, kept: dict) -> list:
    n = p["t"]["check_batches"]
    ids = sorted(kept)
    return sorted(random.Random(data.subseed(p["seed"], 32)).sample(ids, min(n, len(ids))))


def control(inputs, p: dict, mode: str) -> dict:
    """Answers of the reference in the program's place for the batches the
    check samples, computed in the step below the configuration's precision
    (``mode``: "tf32" or "fp8")."""
    batches = _sample(p, dict.fromkeys(range(len(p["q"]))))
    q = np.concatenate([p["q"][b] for b in batches])
    vals, ids = _exact(inputs, q, p["t"]["k"], mode).result()
    n, out = p["q"].shape[1], {}
    for j, b in enumerate(batches):
        rows = slice(j * n, (j + 1) * n)
        out[b] = ([v.numpy().astype(np.float32) for v in vals[rows]],
                  [[int(i) + 1 for i in r] for r in ids[rows]])
    return out


def _exact(inputs, q, k, mode="exact"):
    ex = ref.Exact(torch.as_tensor(q), k,
                   precision="tf32" if mode == "tf32" else "float32",
                   storage="fp8" if mode == "fp8" else "float32")
    for j in range(inputs.n_shards):
        ex.add(inputs.shard(j), j * (inputs.n_rows // inputs.n_shards))
    return ex


def judge(inputs, p: dict, answers: dict) -> dict:
    """``short``: answers with fewer than k hits; ``recall_miss``: 1 -
    recall@k against the float64 exact top-k; ``rank_gap``: the widest
    relative excess of the exact distance of the program's i-th hit over the
    exact i-th distance; ``dist_rel``: the widest relative error of a
    reported distance against its hit's exact distance."""
    k = p["t"]["k"]
    batches = _sample(p, answers)
    q = np.concatenate([p["q"][b] for b in batches])
    ex = _exact(inputs, q, k)
    ref_v, ref_i = ex.result()
    got_d, got_i = [], []
    for b in batches:
        dists, ids = answers[b]
        got_d += [list(map(float, r)) for r in dists]
        got_i += [list(r) for r in ids]
    n_rows = inputs.n_rows
    have = torch.tensor([[j < len(r) and 1 <= r[j] <= n_rows for j in range(k)]
                         for r in got_i])
    short = int((~have).any(1).sum())  # missing hits, or ids of no row
    pad = [r + [1] * (k - len(r)) for r in got_i]
    pos = (torch.tensor(pad, dtype=torch.long) - 1).clamp(0, n_rows - 1)
    rows = inputs.rows_of(pos.flatten().to(inputs.device)).view(len(q), k, -1)
    exact = ref.distances(torch.as_tensor(q, device=inputs.device)[:, None, :], rows).cpu()
    reported = torch.tensor([r + [0.0] * (k - len(r)) for r in got_d], dtype=torch.float64)
    rel = ((reported - exact).abs() / exact.clamp_min(1e-12))[have]
    gap = ((exact - ref_v) / ref_v.clamp_min(1e-12))[have]
    hits = sum(len(set(a) & set((b + 1).tolist())) for a, b in zip(got_i, ref_i))
    return {"short": float(short), "recall_miss": 1.0 - hits / (len(q) * k),
            "rank_gap": float(gap.max()) if len(gap) else float("inf"),
            "dist_rel": float(rel.max()) if len(rel) else float("inf"),
            "queries_checked": float(len(q))}
