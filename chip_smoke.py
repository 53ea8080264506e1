#!/usr/bin/env python3
"""Drive the PyTorch port's query path once on one NVIDIA GPU, and check it.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. env: torch / CUDA versions and the card (``nvidia-smi``'s name and power
   limit, also printed raw on the line after it).
2. build: ``nvcc`` builds ``rag_faiss_embedding_tpu_torch/csrc/flat_scan.cu``
   for sm_90a.
3. kernel: the flat-scan kernel against its plain torch version on the same
   CUDA tensors, over a grid of metrics, dtypes, Q, N, D and k, plus edge
   cases, rows wider than a shared-memory tile, and the 1,048,576 x 384
   float32 database; both timed with CUDA events (median of 10 after
   warm-up).
4. slice: MiniLM-L6 at full width (seeded random weights) ->
   ``RAGManager.initialize_database`` over 4,096 documents -> 8
   ``QueryEngine.search`` requests, one 16-query ``search_batch``, one
   answer -> save, reload in a second manager, search again. Checked
   against the same pipeline and plain scan on the CPU, and the kernel
   against its plain version at the path's own shapes (Q = 1 and Q = 16).
5. trace: the same engine, warm: request latency on the host clock, its
   stages (tokenize, embed, scan, SQLite), a ``torch.profiler`` trace of 8
   requests (device busy time per request, by kernel, and the device's idle
   share), and the encoder's device time at 1, 16 and 32 rows.

Then a ``{"kernels": [...]}`` line (launch counts from the slice's run) and,
last, ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero without the last line. It needs no network and no
JAX; it exits non-zero where no CUDA device is present or the port's
package is not beside it.
"""

import dataclasses
import html
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "rag_faiss_embedding_tpu_torch/csrc/flat_scan.cu"
KERNEL_REPLACES = "rag_faiss_embedding_tpu/ops/pallas_scan.py:80"
N_DOCS = 4096
SEED = 0
# Tolerances of kernel vs plain: both accumulate in float32 in different
# orders, so values agree to rtol 1e-5 (1e-3 for bf16 storage, whose wider
# terms round more) relative to the largest terms that cancel in
# ||q||^2 - (2 q.x - ||x||^2).
RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
CASE_COLUMNS = ["case", "dtype", "metric", "Q", "N", "D", "k", "n_valid",
                "max_abs_err", "id_mismatch", "ms", "plain_ms"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` CUDA-event runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 3
def assert_same_topk(torch, q, db, kv, ki, pv, pi, metric, rtol, n_valid=None):
    """Hold one top-k result (kv, ki) to another (pv, pi) for queries q over
    database db; returns (max_abs_err, id mismatches). Values must agree
    within the tolerance at every slot, and every id of the first result
    must carry its own true distance (recomputed in float64), so ids can
    differ only at near-ties."""
    nv = db.shape[0] if n_valid is None else n_valid
    qf, live = q.double(), db[:nv].double()
    atol = rtol * float((qf * qf).sum(1).max() + (live * live).sum(1).max())
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)) or not torch.equal(kv[~fin], pv[~fin]):
        raise AssertionError(f"missing slots differ ({metric}, k={kv.shape[1]})")
    if not torch.equal(ki < 0, ~fin):
        raise AssertionError("id -1 must pair with an infinite value")
    err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    if fin.any() and not bool(((kv - pv).abs()[fin] <= atol + rtol * pv.abs()[fin]).all()):
        raise AssertionError(f"values differ by {err} ({metric}, k={kv.shape[1]})")
    rows = db[ki.clamp_min(0).long()].double()
    if metric == "L2":
        true = ((qf[:, None, :] - rows) ** 2).sum(-1)
    else:
        true = (qf[:, None, :] * rows).sum(-1)
    if not bool(((true - kv.double()).abs()[fin] <= atol + rtol * true.abs()[fin]).all()):
        raise AssertionError(f"ids do not carry their values ({metric})")
    if bool((ki[fin] >= nv).any()):
        raise AssertionError("a row past n_valid came back")
    return err, int((ki != pi).sum())


def check_scan(torch, F, q, db, db_sq, k, metric, n_valid=None):
    """Kernel vs plain on the same CUDA tensors; returns (max_abs_err,
    id mismatches, kernel ids)."""
    kw = dict(metric=metric, db_sq=db_sq, n_valid=n_valid)
    kv, ki = F.flat_search(q, db, k, **kw)
    torch.cuda.synchronize()
    pv, pi = F.flat_search_reference(q, db, k, **kw)
    rtol = RTOL["bfloat16" if db.dtype == torch.bfloat16 else "float32"]
    err, mism = assert_same_topk(torch, q, db, kv, ki, pv, pi, metric, rtol, n_valid)
    return err, mism, ki


def kernel_phase(torch, F):
    from rag_faiss_embedding_tpu_torch.ops.distance import sqnorms

    g = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    cases, max_err = [], 0.0

    def run(name, q, db, k, metric, n_valid=None):
        nonlocal max_err
        # row norms come precomputed, as the index keeps them
        db_sq = sqnorms(db)
        err, mism, ki = check_scan(torch, F, q, db, db_sq, k, metric, n_valid)
        max_err = max(max_err, err)
        kw = dict(metric=metric, db_sq=db_sq, n_valid=n_valid)
        row = [name, str(db.dtype).removeprefix("torch."), metric, q.shape[0],
               db.shape[0], db.shape[1], k, n_valid, err, mism,
               cuda_ms(torch, lambda: F.flat_search(q, db, k, **kw)),
               cuda_ms(torch, lambda: F.flat_search_reference(q, db, k, **kw))]
        cases.append(row)
        return ki

    for d in (16, 384):
        qs = {nq: randn(nq, d) for nq in (1, 7, 1024)}
        for n in (1000, 65536):
            base = randn(n, d)
            for dtype in (torch.float32, torch.bfloat16):
                db = base.to(dtype)
                for metric in ("L2", "IP"):
                    for nq, q in qs.items():
                        for k in (1, 5, 10, 64):
                            run("grid", q.to(dtype), db, k, metric)
    for metric in ("L2", "IP"):
        db, q = randn(65536, 384), randn(7, 384)
        run("n_valid<N", q, db, 10, metric, n_valid=40000)
        ki = run("k>n_valid", q, db, 10, metric, n_valid=3)
        if not bool((ki[:, 3:] == -1).all()):
            raise AssertionError("k > n_valid must give -1 past the live rows")
        row = randn(1, 384)
        ki = run("identical rows", row, row.repeat(5000, 1), 10, metric)
        if ki[0].tolist() != list(range(10)):
            raise AssertionError(f"ties must go to the lowest ids, got {ki[0].tolist()}")
        run("ragged Q,N", randn(37, 100), randn(12345, 100), 10, metric)
    # rows wider than a shared-memory tile go in column chunks; 1030 takes
    # the scalar staging path, 2048 the 16-byte one
    for d in (1030, 2048):
        base = randn(12345, d)
        for dtype in (torch.float32, torch.bfloat16):
            for metric in ("L2", "IP"):
                for nq in (1, 37):
                    run("wide rows", randn(nq, d).to(dtype), base.to(dtype), 10, metric)
    big = randn(1 << 20, 384)
    for nq in (1, 1024):
        run("1M x 384", randn(nq, 384), big, 10, "L2")
    del big
    torch.cuda.empty_cache()
    return cases, max_err


# ------------------------------------------------------------------ phase 4
def same_hits(a, b, rtol=1e-5, atol=1e-4) -> bool:
    """Two result lists agree: equal length, distances within the tolerance
    at every slot, and ids equal except where a distance ties another in
    its list (or sits in the last slot, whose runner-up is not shown)."""
    import numpy as np

    da = np.array([h["distance"] for h in a])
    if len(a) != len(b) or not np.allclose(
            da, [h["distance"] for h in b], rtol=rtol, atol=atol):
        return False
    for p, (x, y) in enumerate(zip(a, b)):
        tied = np.isclose(np.delete(da, p), da[p], rtol=rtol, atol=atol).any()
        if x["id"] != y["id"] and not tied and p != len(a) - 1:
            return False
    return True


def corpus_documents(n_docs: int, seed: int):
    """The example HTML pages (tags stripped) plus seeded synthetic
    documents drawn from their words, ``n_docs`` in all."""
    import numpy as np

    docs = []
    for path in sorted((ROOT / "examples" / "corpus").glob("*.html")):
        raw = path.read_text(encoding="utf-8")
        title = re.search(r"<title>(.*?)</title>", raw, re.S)
        body = re.sub(r"<(script|style|head)\b.*?</\1>", " ", raw, flags=re.S | re.I)
        text = " ".join(html.unescape(re.sub(r"<[^>]+>", " ", body)).split())
        docs.append({"url": f"https://docs.example/{path.name}",
                     "title": title.group(1) if title else path.name,
                     "content": text})
    words = sorted({w.lower() for d in docs for w in re.findall(r"[A-Za-z]+", d["content"])})
    rng = np.random.default_rng(seed)
    for i in range(len(docs), n_docs):
        body = " ".join(rng.choice(words, size=int(rng.integers(20, 120))))
        docs.append({"url": f"https://synthetic.example/{i}",
                     "title": f"synthetic {i}",
                     "content": f"Document {i}. {body.capitalize()}."})
    return docs


def slice_phase(torch, F, workdir: Path):
    import numpy as np

    from rag_faiss_embedding_tpu.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import FlatIndex
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline
    from rag_faiss_embedding_tpu_torch.models import convert
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    cfg = Config(base_dir=workdir, model_name="chip-smoke-random-init")
    rng = np.random.default_rng(SEED + 1)
    picks = [0, 3] + sorted(int(i) for i in rng.choice(
        np.arange(5, N_DOCS), size=6, replace=False))
    queries = [docs[i]["content"] for i in picks]
    batch_queries = [docs[int(i)]["content"]
                     for i in rng.choice(N_DOCS, size=15, replace=False)]
    batch_queries.append("how do sentence encoders pool token states")

    F.flat_search.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    manager = RAGManager(config=cfg, device=cuda)
    n = manager.initialize_database(docs)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    engine = QueryEngine(manager.db, manager.vector_store, manager.embedder,
                         generator=AnswerGenerator(backend="extractive"))
    latencies, singles = [], []
    for text in queries:
        t = time.perf_counter()
        singles.append(engine.search(text, top_k=5))
        latencies.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    batch = engine.search_batch(batch_queries, top_k=5)
    batch_ms = (time.perf_counter() - t) * 1e3
    answer = engine.generate_response(batch_queries[-1], batch[-1])
    manager.vector_store.save_index()
    convert.export_params(
        convert.to_flax_params(manager.embedder.model.state_dict(),
                               manager.embedder.cfg),
        cfg.data_dir / "encoder_params.npz")
    reloaded = RAGManager(config=cfg, device=cuda)
    engine2 = QueryEngine(reloaded.db, reloaded.vector_store, reloaded.embedder,
                          generator=AnswerGenerator(backend="extractive"))
    singles2 = [engine2.search(text, top_k=5) for text in queries]
    torch.cuda.synchronize()
    launches = F.flat_search.launches
    n_searches = len(queries) * 2 + 1

    # --- checks
    if n != N_DOCS or manager.vector_store.ntotal != N_DOCS:
        raise AssertionError(f"ingested {n} of {N_DOCS} documents")
    if any(not hits for hits in singles + singles2 + batch):
        raise AssertionError("a request returned no documents")
    self_hits = sum(hits[0]["url"] == docs[i]["url"] for hits, i in zip(singles, picks))
    if self_hits < 7:
        raise AssertionError(f"self-retrieval held for {self_hits} of 8")
    if launches < n_searches:
        raise AssertionError(f"kernel launched {launches} times for {n_searches} searches")
    index = manager.vector_store.index
    on_card = [index._buf.is_cuda, index._sq.is_cuda] + [
        p.is_cuda for p in manager.embedder.model.parameters()]
    if not all(on_card) or not reloaded.vector_store.index._buf.is_cuda:
        raise AssertionError("an index or encoder tensor is off the card")
    for a, b in zip(singles, singles2):
        if not same_hits(a, b):
            raise AssertionError("the reloaded manager answers differently")
    if not answer:
        raise AssertionError("no answer generated")

    # the same pipeline on the CPU: embeddings, then the plain scan
    cpu_pipe = EmbeddingPipeline(
        params=convert.to_flax_params(manager.embedder.model.state_dict(),
                                      manager.embedder.cfg),
        cfg=manager.embedder.cfg, tokenizer=manager.embedder.tokenizer,
        device="cpu")
    card_emb = manager.embedder.generate_embeddings(queries)
    cpu_emb = cpu_pipe.generate_embeddings(queries)
    emb_err = float(np.abs(card_emb - cpu_emb).max())
    if emb_err > 1e-3:
        raise AssertionError(f"card vs CPU embeddings differ by {emb_err}")
    cpu_index = FlatIndex.from_state_dict(index.state_dict(), device="cpu")
    card_v, card_i = index.search(card_emb, 5)
    cpu_v, cpu_i = cpu_index.search(card_emb, 5)
    # the random-init encoder packs documents close together, so near-ties
    # among the top 5 are common: ids may differ only where values tie
    _, top5_mismatch = assert_same_topk(
        torch, torch.from_numpy(card_emb), torch.from_numpy(cpu_index.vectors()),
        card_v.cpu(), card_i.cpu(), cpu_v, cpu_i, "L2", RTOL["float32"])

    # search_batch's hits against the CPU plain search on the same
    # embeddings, by the same rule (hits mapped back to index rows)
    batch_emb = manager.embedder.generate_embeddings(batch_queries)
    cpu_bv, cpu_bi = cpu_index.search(batch_emb, 5)
    row_of = {d: p for p, d in enumerate(manager.vector_store.doc_ids)}
    hit_v = torch.tensor([[h["distance"] for h in hits] for hits in batch])
    hit_i = torch.tensor([[row_of[h["id"]] for h in hits] for hits in batch],
                         dtype=torch.int32)
    _, batch_mismatch = assert_same_topk(
        torch, torch.from_numpy(batch_emb), torch.from_numpy(cpu_index.vectors()),
        hit_v, hit_i, cpu_bv, cpu_bi, "L2", RTOL["float32"])

    # kernel vs plain at the main path's shapes, on distinct queries (after
    # the launch count): Q = 1 (one request) and Q = 16 (search_batch)
    shapes = {}
    for emb in (card_emb[:1], batch_emb):
        q = torch.from_numpy(emb).to(cuda)
        err, mism, _ = check_scan(torch, F, q, index._buf, index._sq, 5, "L2",
                                  index.ntotal)
        args = (q, index._buf, 5)
        kw = dict(db_sq=index._sq, n_valid=index.ntotal)
        shapes[f"Q={q.shape[0]}"] = {
            "N": index.ntotal, "D": index.dim, "k": 5,
            "max_abs_err": err, "id_mismatch": mism,
            "ms": cuda_ms(torch, lambda: F.flat_search(*args, **kw)),
            "plain_ms": cuda_ms(torch, lambda: F.flat_search_reference(*args, **kw)),
        }
    trace = trace_phase(torch, engine, queries, batch_queries)
    manager.cleanup()
    reloaded.cleanup()
    return trace, {
        "phase": "slice", "documents": n,
        "encoder": dataclasses.asdict(manager.embedder.cfg),
        "ingest_s": ingest_s, "request_ms": latencies,
        "request_ms_median": statistics.median(latencies),
        "batch16_ms": batch_ms, "self_retrieval": f"{self_hits}/8",
        "flat_scan_launches": launches, "searches": n_searches,
        "embedding_max_abs_err_vs_cpu": emb_err,
        "top5_id_mismatch_vs_cpu": top5_mismatch,
        "batch_top5_id_mismatch_vs_cpu": batch_mismatch,
        "main_path_kernel_times": shapes, "answer_chars": len(answer),
    }


# ------------------------------------------------------------------ phase 5
def device_busy_ms(events):
    """Union of the device intervals of profiler ``events``, in ms, and the
    device time by kernel name."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return busy_us / 1e3, by_name


def trace_phase(torch, engine, queries, batch_queries):
    """Where a warm request's time goes, on the host clock and the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    emb, store = engine.embedder, engine.vector_store
    for text in queries:  # warm every shape the requests take
        engine.search(text, top_k=5)
    wall = []
    for text in queries * 3:
        t = time.perf_counter()
        engine.search(text, top_k=5)
        wall.append((time.perf_counter() - t) * 1e3)
    stages = {"tokenize": [], "embed_query": [], "vector_store.search": [],
              "sqlite_fetch": []}
    for text in queries:
        t = time.perf_counter()
        emb.tokenizer.encode_batch([text], emb.max_seq_length)
        stages["tokenize"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        vec = emb.embed_query(text)  # ends in a device-to-host copy
        stages["embed_query"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        _, ids = store.search(vec, 5)  # so does this
        stages["vector_store.search"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        engine.db.get_documents_by_ids(ids)
        stages["sqlite_fetch"].append((time.perf_counter() - t) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for text in queries:
            engine.search(text, top_k=5)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms, by_name = device_busy_ms(on_card)
    n = len(queries)
    wall_ms = statistics.median(wall)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    # the encoder's device time by batch rows, at the batch's sequence bucket
    ids, mask = emb.tokenizer.encode_batch(batch_queries, emb.max_seq_length)
    ids32 = np.pad(ids, ((0, 32 - len(ids)), (0, 0)), constant_values=emb.tokenizer.pad_id)
    mask32 = np.pad(mask, ((0, 32 - len(mask)), (0, 0)))
    encoder_ms = {rows: cuda_ms(torch, lambda: emb._forward(ids32[:rows], mask32[:rows]))
                  for rows in (1, 16, 32)}
    return {
        "phase": "trace", "requests": len(wall), "request_ms_median": wall_ms,
        "request_ms_min": min(wall), "request_ms_max": max(wall),
        "stage_ms_median": {k: statistics.median(v) for k, v in stages.items()},
        "traced_requests": n, "traced_ms_per_request": traced_ms / n,
        "device_busy_ms_per_request": busy_ms / n if on_card else None,
        # busy time against the untraced median; the traced wall is longer
        "idle_share": 1 - busy_ms / n / wall_ms if on_card else None,
        "idle_share_traced": 1 - busy_ms / traced_ms if on_card else None,
        "device_ms_per_request_by_kernel": [[name[:70], us / 1e3 / n] for name, us in top],
        "encoder_seq_bucket": int(ids.shape[1]),
        "encoder_ms_by_rows": encoder_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU")
    if not (ROOT / "rag_faiss_embedding_tpu_torch" / "__init__.py").exists():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    print(smi, flush=True)

    from rag_faiss_embedding_tpu_torch import _build
    from rag_faiss_embedding_tpu_torch.ops import flat_scan as F

    t0 = time.perf_counter()
    lib = _build.build("flat_scan")
    F.load()  # loads the library and binds its entry points
    emit({"phase": "build", "source": KERNEL_SOURCE, "library": str(lib.relative_to(ROOT)),
          "nvcc_s": _build.build.seconds.get("flat_scan"),
          "build_and_load_s": time.perf_counter() - t0})

    cases, max_err = kernel_phase(torch, F)
    emit({"phase": "kernel", "kernel": "flat_scan", "rtol": RTOL,
          "atol": "rtol x (max ||q||^2 + max ||x||^2)", "columns": CASE_COLUMNS,
          "cases": cases})

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
        trace, sl = slice_phase(torch, F, Path(workdir))
    emit(sl)
    emit(trace)

    loaded = [m for m in ("jax", "flax", "rag_faiss_embedding_tpu.ops") if m in sys.modules]
    if loaded:
        raise AssertionError(f"the port pulled in JAX modules: {loaded}")
    main_shape = sl["main_path_kernel_times"]["Q=1"]
    emit({"kernels": [{
        "name": "flat_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sl["flat_scan_launches"],
        "max_abs_err": max(max_err, *(v["max_abs_err"]
                                      for v in sl["main_path_kernel_times"].values())),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
