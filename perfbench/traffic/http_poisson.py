"""Open-loop arrivals to ``POST /search`` of the program's ``SearchApp``.

Parameters (the cell file's ``params``): ``rate`` requests a second;
``words``: query lengths, log-normal (``median``, ``sigma``) clipped to
[``lo``, ``hi``]; ``top_k``; ``warm_s`` of the same traffic before the
window (set-up); ``connections`` opened before the start; ``timeout_s``;
``check_requests``, how many answered requests the output check judges.
Optional: ``burst`` {``period_s``, ``on_s``, ``factor``}, arrivals
``factor`` times as dense in the first ``on_s`` of every period at the
same mean rate.

The gaps between arrivals are exponential, drawn once for every seed and
put in an order drawn from the seed, so every seed offers the same load.
Query texts are windows of the corpus's word stream. The server runs in
this process on an asyncio loop with its one worker thread; the load
generator (``loadgen.py``) runs in a process of its own. Each request is
timed from its due time to the last byte of its answer.
"""

from __future__ import annotations

import asyncio
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import data
from ..reference import search as ref
from ..reference.minilm import MiniLM
from ..reference.wordpiece import WordPiece

LOADGEN = Path(__file__).with_name("loadgen.py")
START_S = 1.0  # from launching the generator to its first due time


def _arrivals(t: dict, seed: int, n: int, seconds: float, tag: int) -> np.ndarray:
    gaps = data.fixed_then_shuffled(seed, tag, lambda g: g.exponential(1.0, n))
    u = (np.cumsum(gaps) - gaps) / gaps.sum()  # in [0, 1)
    b = t.get("burst")
    if not b:
        return u * seconds
    # arrivals of a unit process mapped through the burst's cumulative intensity
    grid = np.linspace(0.0, seconds, 4097)
    phase = grid % b["period_s"]
    density = np.where(phase < b["on_s"], b["factor"], 1.0)
    cum = np.concatenate([[0.0], np.cumsum((density[1:] + density[:-1]) / 2 * np.diff(grid))])
    return np.interp(u, cum / cum[-1], grid)


def _requests(t: dict, inputs, seed: int, n: int, seconds: float, tag: int) -> list:
    w = t["words"]
    lengths = data.fixed_then_shuffled(
        seed, tag + 1, data.lognormal_lengths(n, w["median"], w["sigma"], w["lo"], w["hi"]))
    spans = data.windows(inputs.corpus.stream, seed, tag + 2, lengths)
    texts = [inputs.corpus.stream.window(int(s), int(k)) for s, k in spans]
    bodies = [json.dumps({"text": x, "top_k": t["top_k"], "generate": False}) for x in texts]
    return list(zip(_arrivals(t, seed, n, seconds, tag).tolist(), bodies)), texts


def plan(cell: dict, inputs, seed: int, seconds: float) -> dict:
    t = cell["params"]
    n = int(round(t["rate"] * seconds))
    n_warm = int(round(t["rate"] * t["warm_s"]))
    warm, _ = _requests(t, inputs, seed, n_warm, t["warm_s"], 50)
    reqs, texts = _requests(t, inputs, seed, n, seconds, 60)
    pick = random.Random(data.subseed(seed, 61)).sample(range(n), min(n, t["check_requests"]))
    sample = sorted(set(pick) | {int(np.argmax([len(x) for x in texts]))})
    return {"t": t, "seed": seed, "warm": warm, "requests": reqs, "texts": texts,
            "sample": sample}


def prepare(program, p: dict) -> None:
    """Every shape the window can meet: each batch size up to the server's
    largest, at the shortest, a middle and the longest query length (the
    encoder's product shapes and K1's launch shape follow them)."""
    engine, k = program.engine, p["t"]["top_k"]
    stream, w = program.inputs.corpus.stream, p["t"]["words"]
    for n_words in (w["lo"], w["median"] * 3, w["hi"]):
        texts = [stream.window(i * 64, n_words) for i in range(program.port_config.serve_max_batch)]
        for b in range(1, len(texts) + 1):
            engine.search_batch(texts[:b], k)
    program.sync()


def instrument(program, spans) -> None:
    emb = program.embedder
    spans.wrap(program.engine, "search_batch", "engine.search_batch",
               lambda a, kw, out: {"rows": len(a[0])})
    spans.wrap(emb, "generate_embeddings", "embedder.generate_embeddings",
               lambda a, kw, out: {"rows": len(out)})
    spans.wrap(program.tokenizer, "encode_batch", "tokenizer.encode_batch",
               lambda a, kw, out: {"real": out[1].sum(1).tolist(), "positions": out[1].size})
    spans.wrap(program.store, "search", "vector_store.search",
               lambda a, kw, out: {"q": a[0], "k": a[1]})
    spans.wrap(program.db, "get_documents_by_ids", "db.get_documents_by_ids")


async def _serve(program, p: dict, seconds: float, dev, workdir: Path) -> dict:
    from rag_faiss_embedding_tpu_torch.serve.api import SearchApp

    t = p["t"]
    app = SearchApp(program.engine, program.port_config)
    await app.start("127.0.0.1", 0)
    n_warm = len(p["warm"])
    proc = None
    try:
        with dev.window():
            t0 = time.monotonic() + START_S
            w0 = t0 + t["warm_s"]
            plan_file, out_file = workdir / "loadgen_plan.json", workdir / "loadgen_out.json"
            plan_file.write_text(json.dumps({
                "port": app.port, "t0": t0, "timeout_s": t["timeout_s"],
                "connections": t["connections"], "keep": [n_warm + i for i in p["sample"]],
                "requests": p["warm"] + [[t["warm_s"] + o, b] for o, b in p["requests"]]}))
            proc = await asyncio.create_subprocess_exec(
                sys.executable, str(LOADGEN), str(plan_file), str(out_file),
                stdin=subprocess.DEVNULL)
            await asyncio.sleep(max(0.0, w0 - time.monotonic()))
            _, before = await app.stats(b"")
            if await proc.wait() != 0:
                raise RuntimeError("the load generator failed")
            _, after = await app.stats(b"")
    finally:
        if proc is not None and proc.returncode is None:  # never leave it running
            proc.kill()
            await proc.wait()
        await app.stop()
    out = json.loads(out_file.read_text())
    return {"w0": w0, "before": before, "after": after, "out": out, "n_warm": n_warm}


def outcome(reqs: list, timeout_s: float):
    """Latency of each request from its due time in ms (one that never came
    waited at least the generator's timeout), the failed count (no answer,
    an error status, or an empty answer), and how late the generator sent."""
    lat, failed = [], 0
    for due, sent, done, status, empty in reqs:
        failed += done < 0 or status != 200 or empty
        lat.append((timeout_s if done < 0 else done - due) * 1e3)
    late = sorted((sent - due) * 1e3 for due, sent, *_ in reqs)
    return lat, failed, {"p50": statistics.median(late),
                         "p99": late[int(0.99 * (len(late) - 1))], "max": late[-1]}


def window(program, p: dict, seconds: float, dev) -> dict:
    r = asyncio.run(_serve(program, p, seconds, dev, program.workdir))
    reqs = r["out"]["requests"][r["n_warm"]:]
    lat, failed, late = outcome(reqs, p["t"]["timeout_s"])
    batches = {}
    for key, st in r["after"].items():
        if key.startswith("batch_search(n="):
            n = st["count"] - r["before"].get(key, {}).get("count", 0)
            if n:
                batches[int(key[len("batch_search(n="):-1])] = n
    w0 = int(r["w0"] * 1e9)
    return {"t0": w0, "t1": w0 + int(seconds * 1e9), "window_s": float(seconds),
            "latencies_ms": lat, "attempted": len(reqs), "failed": failed,
            "done": {"queries": len(reqs) - failed}, "batches": batches,
            "lateness_ms": late,
            "bodies": {int(i) - r["n_warm"]: b for i, b in r["out"]["bodies"].items()}}


def collect(program, p: dict, rec: dict) -> dict:
    out = {}
    for i in p["sample"]:
        body = rec["bodies"].get(i)
        out[i] = json.loads(body)["similar_documents"] if body is not None else None
    return out


def _embed(inputs, texts: list, precision: str) -> torch.Tensor:
    tok = WordPiece(inputs.vocab.tokens)
    model = MiniLM(inputs.weights, inputs.model, precision)
    max_len = inputs.config["port"]["max_seq_length"]
    return model.embed_many([tok.encode(x, max_len) for x in texts])


def _exact(inputs, q: torch.Tensor, k: int, precision: str):
    ex = ref.Exact(q, k, precision=precision)
    for j in range(inputs.n_shards):
        ex.add(inputs.shard(j), j * (inputs.n_rows // inputs.n_shards))
    return ex.result()


def control(inputs, p: dict, mode: str) -> dict:
    """Answers of the reference in the program's place, its products in
    ``mode`` ("tf32"): the documents and scores as the server gives them."""
    k = p["t"]["top_k"]
    q = _embed(inputs, [p["texts"][i] for i in p["sample"]], mode)
    vals, ids = _exact(inputs, q, k, mode)
    out = {}
    for j, i in enumerate(p["sample"]):
        hits = []
        for v, row in zip(vals[j].tolist(), ids[j].tolist()):
            d = float(np.float32(v))
            hits.append({"id": row + 1, **inputs.corpus.document(row), "distance": d,
                         "score": 1.0 / (1.0 + d)})
        out[i] = hits
    return out


def judge(inputs, p: dict, answers: dict) -> dict:
    """``missing``: sampled requests with no answer; ``short``: answers with
    fewer than top_k hits or an id of no document; ``doc_mismatch``: hits
    whose url, title or content is not the stored document's, or whose
    score is not 1 / (1 + distance); ``rank_gap`` and ``dist_rel`` as in
    ``vector_search.judge``, against the reference's own embedding of the
    query text and its float64 exact top-k."""
    k, n_rows = p["t"]["top_k"], inputs.n_rows
    sample = [i for i in p["sample"] if answers.get(i) is not None]
    missing = len(p["sample"]) - len(sample)
    q = _embed(inputs, [p["texts"][i] for i in sample], "float32")
    ref_v, _ = _exact(inputs, q, k, "float32")
    short = mismatch = 0
    ids = torch.ones(len(sample), k, dtype=torch.long)
    reported = torch.zeros(len(sample), k, dtype=torch.float64)
    have = torch.zeros(len(sample), k, dtype=torch.bool)
    for j, i in enumerate(sample):
        hits = answers[i]
        ok = [h for h in hits if isinstance(h.get("id"), int) and 1 <= h["id"] <= n_rows]
        short += len(ok) < k or len(hits) > k
        for r, h in enumerate(ok[:k]):
            ids[j, r], reported[j, r], have[j, r] = h["id"], h["distance"], True
            want = inputs.corpus.document(h["id"] - 1)
            if (any(h.get(f) != want[f] for f in ("url", "title", "content"))
                    or abs(h["score"] - 1.0 / (1.0 + h["distance"])) > 1e-12):
                mismatch += 1
    rows = inputs.rows_of((ids - 1).flatten().to(inputs.device)).view(len(sample), k, -1)
    exact = ref.distances(q.to(inputs.device)[:, None, :], rows).cpu()
    rel = ((reported - exact).abs() / exact.clamp_min(1e-12))[have]
    gap = ((exact - ref_v) / ref_v.clamp_min(1e-12))[have]
    return {"missing": float(missing), "short": float(short), "doc_mismatch": float(mismatch),
            "rank_gap": float(gap.max()) if len(gap) else float("inf"),
            "dist_rel": float(rel.max()) if len(rel) else float("inf"),
            "requests_checked": float(len(sample))}
