#!/usr/bin/env python3
"""Drive the PyTorch port's query path once on one NVIDIA GPU, and check it.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. env: torch / CUDA versions and the card (``nvidia-smi``'s name and power
   limit, also printed raw on the line after it).
2. build: ``nvcc`` builds ``rag_faiss_embedding_tpu_torch/csrc/flat_scan.cu``,
   ``csrc/union_scan.cu``, ``csrc/pq_decode.cu``, ``csrc/fused_proto.cu`` and
   ``csrc/kernel_probe.cu`` for sm_90a, all at once.
3. kernel: the flat-scan kernel against its plain torch version on the same
   CUDA tensors, over a grid of metrics, dtypes, Q, N, D and k, plus edge
   cases, k above KMAX (to 5,000, whose lists live in global memory), 30%
   of the rows dead, rows wider than a shared-memory tile, and the 1,048,576 x 384
   float32 database at Q = 1, 16, 64, 256 and 1,024; both timed with CUDA
   events (median of 10 after warm-up). There, each stage-1 path of the
   kernel (one query per warp, the tiled block) is forced at each Q of
   CROSSOVER_Q, held to the plain version and timed: the measurements that
   place the wrapper's crossover between them.
4. slice: MiniLM-L6 at full width (seeded random weights) ->
   ``RAGManager.initialize_database`` over 4,096 documents -> 8
   ``QueryEngine.search`` requests, one 16-query ``search_batch``, one
   answer -> save, reload in a second manager, search again. Checked
   against the same pipeline and plain scan on the CPU, and the kernel
   against its plain version at the path's own shapes (Q = 1 and Q = 16).
   Then one request for 100 hits, above the tiled path's KMAX: the kernel
   serves it (one launch) and it is held to the CPU index. The kernel phase
   holds K1 to its plain version at k up to 5,000 and with dead rows too.
5. trace: the same engine, warm: request latency on the host clock, its
   stages (tokenize, embed, scan, SQLite), a ``torch.profiler`` trace of 8
   requests (device busy time per request, by kernel, and the device's idle
   share), and the encoder's device time at 1, 16 and 32 rows.
6. ivf_kernel: 1,048,576 x 384 rows of bench.py's distribution (8,192
   Gaussian modes, rows = mode + 0.7 noise, queries = a row + 0.3 noise),
   made on the card from a seeded generator, in ``IVFFlatIndex(384,
   nlist=8192, dtype="bfloat16", train_iters=10, balance="reassign")``.
   Searches at Q = 1 and Q = 1,024, k = 10, at the library's default
   dispatch and at nprobe 16, through union-scan variants 1 and 2 and the
   plain chunk body; recall@10 of each against the exact float32 flat top-10
   (the port's ``FlatIndex``); each kernel against ``union_scan_reference``
   on the same card tensors at those shapes, CUDA-event times of both; then
   removed rows under variant 2 and k past the candidates. Before those,
   on the untouched index, phase 10.
7. ivf_slice: ``RAGManager(index_kind="ivf", ivf_nlist=64)`` over the same
   4,096 documents as the slice phase, the same requests, save and reload,
   checked against the saved index searched on the CPU through the kernel's
   plain version; and its trace (as phase 5).
8. pq_kernel: the PQ decode kernel against ``decode_reference`` on the same
   card tensors, bit for bit, over D = 384 with M 16 / 48 / 96 and D = 768
   with M 96, ksub 16 and 256, bf16 and f32 codebooks, N from 0 to
   1,048,576, CUDA-event times of both. Then phase 6's 1M rows in
   ``PQIndex(384, m=48)``, ``IVFFlatIndex(384, nlist=8192, pq_m=48,
   balance="reassign", train_iters=10)`` and the same IVF-PQ with
   ``rerank=True`` (int8 refine, depth 64; its coarse quantizer and codec
   reused): build times and stats, searches at k = 10, Q = 1 and 1,024, at
   nprobe 8 and at the first nprobe whose union streams in more than one
   segment, through the kernel (``backend="auto"``) and the plain decode
   (``"xla"``), which must return identical ids and values; recall@10 of each
   against the exact float32 top-10 (information: the codec bounds it); the
   kernel against its plain version at the path's shapes.
9. pq_slice: ``RAGManager(index_kind="pq")``, then ``RAGManager(
   index_kind="ivf", ivf_nlist=64, ivf_pq_m=48)``, over the slice's
   documents and requests, saved and reloaded, checked against the saved
   index searched on the CPU through the plain decode (each id carries its
   own ADC distance to the decoded reconstruction); the kernel against its
   plain version at the path's shapes, and each manager's trace.

10. fused_proto: the IVF prototype (``benchmarks.fused_proto.search``, UCAP =
    QC = 256, BB 16, KP 10, k 10) over phase 6's index at Q = 1,024, through
    K5 and through its plain version: recall@10 of both against the exact
    top-10 (the IVF gate), distances within the tolerance and ids that
    differ only at near-ties (``proto_search_check``); K5 against
    ``block_topk_reference`` (``block_topk_check``: the tensor cores sum in
    another order, so scores to rtol, ids carrying their own float64
    scores) at the path's shapes, kp 1 and 32, a cell with 3 live rows and
    a row twice in one cell (both exact); CUDA-event times of K5, its plain
    version, both searches and ``IVFFlatIndex.search``.
11. kernel_probe: ``benchmarks.kernel_probe.run`` at the script's shape
    (synthetic blocks, nlist 8,192, window 256, D 384, QC 256, U 260, BB 10,
    CAP 2, 4 chunks): each variant timed, then held to ``probe_reference``
    (``probe_check``: values to rtol plus two packing quanta, each carrying
    its own block's float64 score; NaN bins exact), ``chain`` to ``temps``
    bit for bit, and a crafted negative-subnormal score that ``temps_f32``
    keeps as a NaN.
12. bounds: each kernel's bound at the 1M shapes (the least time for its
    bytes at 3.35 TB/s or its operations at the peak of the unit the exact
    result needs), beside the times the earlier phases took there (K4 at 1M
    rows with ``F.embedding``, from phase 8's grid), each with its achieved
    TFLOP/s and its share of the bound (bound_ms / ms).

Then a ``{"kernels": [...]}`` line (launch counts from each kernel's path:
the flat scan's from the slice, union-scan variant 1's from the IVF slice,
variant 2's from the IVF kernel phase, the PQ decode's from the PQ slice,
K5's from the prototype search, K6's from the probe's run; each with its
bound at the path's shape, its achieved TFLOP/s and share of that bound,
and the one-call library time where one exists)
and, last, ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero without the
last line. It needs no network and loads nothing of JAX or the JAX
package; it exits non-zero where no CUDA device is present or the port's
package is not beside it.
"""

import concurrent.futures
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
UNION_SOURCE = "rag_faiss_embedding_tpu_torch/csrc/union_scan.cu"
UNION_REPLACES = {1: "rag_faiss_embedding_tpu/ops/pallas_ivf.py:182",
                  2: "rag_faiss_embedding_tpu/ops/pallas_ivf.py:100"}
PQ_SOURCE = "rag_faiss_embedding_tpu_torch/csrc/pq_decode.cu"
PQ_REPLACES = "rag_faiss_embedding_tpu/ops/pallas_pq.py:59"
IVF_N, IVF_DIM, IVF_MODES, IVF_NLIST, IVF_Q = 1 << 20, 384, 8192, 8192, 1024
RECALL_MIN, RECALL_SLACK = 0.95, 0.005
FP_SOURCE = "rag_faiss_embedding_tpu_torch/csrc/fused_proto.cu"
FP_REPLACES = "benchmarks/pallas_fused_proto.py:71"
KP_SOURCE = "rag_faiss_embedding_tpu_torch/csrc/kernel_probe.cu"
KP_REPLACES = "benchmarks/pallas_kernel_probe.py:57"
# The card's published peaks (H100 SXM, dense): HBM bytes per second, and
# operations per second of the unit an exact result needs: FP32 outside the
# tensor cores for float32 storage, bf16 tensor cores (float32 accumulation,
# exact products) for bf16 storage.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# top-level packages the port must never load
FORBIDDEN_MODULES = ("jax", "flax", "rag_faiss_embedding_tpu")
N_DOCS = 4096
SEED = 0
# Tolerances of kernel vs plain: both accumulate in float32 in different
# orders, so values agree to rtol 1e-5 (1e-3 for bf16 storage, whose wider
# terms round more) relative to the largest terms that cancel in
# ||q||^2 - (2 q.x - ||x||^2).
RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# K5 and K6 multiply bf16 by bf16, products exact in float32: only the
# float32 summation order separates the tensor cores from the plain version,
# so they are held to float32's rtol
RTOL_EXACT_PRODUCTS = RTOL["float32"]
# Q of the 1M x 384 float32 flat scans: each stage-1 path of K1 is timed at
# each, to place the wrapper's crossover between them (ops/flat_scan.py)
CROSSOVER_Q = (1, 7, 16, 24, 25, 32, 64, 256, 1024)
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


def check_scan(torch, F, q, db, db_sq, k, metric, n_valid=None, dead=None):
    """Kernel vs plain on the same CUDA tensors; returns (max_abs_err,
    id mismatches, kernel ids). No row marked ``dead`` may come back."""
    kw = dict(metric=metric, db_sq=db_sq, n_valid=n_valid, dead=dead)
    kv, ki = F.flat_search(q, db, k, **kw)
    torch.cuda.synchronize()
    pv, pi = F.flat_search_reference(q, db, k, **kw)
    rtol = RTOL["bfloat16" if db.dtype == torch.bfloat16 else "float32"]
    err, mism = assert_same_topk(torch, q, db, kv, ki, pv, pi, metric, rtol, n_valid)
    if dead is not None and bool(dead[ki.clamp_min(0).long()][ki >= 0].any()):
        raise AssertionError("a dead row came back")
    return err, mism, ki


def kernel_phase(torch, F):
    from rag_faiss_embedding_tpu_torch.ops.distance import sqnorms

    g = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    cases, max_err = [], 0.0

    def run(name, q, db, k, metric, n_valid=None, dead=None):
        nonlocal max_err
        # row norms come precomputed, as the index keeps them
        db_sq = sqnorms(db)
        err, mism, ki = check_scan(torch, F, q, db, db_sq, k, metric, n_valid, dead)
        max_err = max(max_err, err)
        kw = dict(metric=metric, db_sq=db_sq, n_valid=n_valid, dead=dead)
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
        # k above KMAX (the warp path's long lists; 5,000 in global memory),
        # and tombstones / filters as the kernel's dead rows
        dead = torch.rand(65536, generator=g, device="cuda") < 0.3
        for nq, k in ((1, 100), (7, 100), (256, 100), (1, 1000), (7, 1000)):
            run("k>KMAX", randn(nq, 384), db, k, metric)
        run("k>KMAX", randn(7, 384), db[:8192], 5000, metric)  # lists in global memory
        for nq, k in ((1, 10), (7, 100), (256, 10)):
            run("dead rows", randn(nq, 384), db, k, metric, dead=dead)
    # rows wider than a shared-memory tile go in column chunks; 1030 takes
    # the scalar staging path, 2048 the 16-byte one
    for d in (1030, 2048):
        base = randn(12345, d)
        for dtype in (torch.float32, torch.bfloat16):
            for metric in ("L2", "IP"):
                for nq in (1, 37):
                    run("wide rows", randn(nq, d).to(dtype), base.to(dtype), 10, metric)
    big = randn(1 << 20, 384)
    big_sq = sqnorms(big)
    paths = {}
    for nq in CROSSOVER_Q:
        q = randn(nq, 384)
        if nq in (1, 16, 64, 256, 1024):  # the default path, checked and timed
            run("1M x 384", q, big, 10, "L2")
        # each stage-1 path forced: held to the plain version, then timed
        paths[nq] = {"chosen": next(k for k, v in F.PATHS.items() if v == F.choose_path(nq))}
        for name in F.PATHS:
            kw = dict(db_sq=big_sq, path=name)
            kv, ki = F.flat_search(q, big, 10, **kw)
            torch.cuda.synchronize()
            pv, pi = F.flat_search_reference(q, big, 10, db_sq=big_sq)
            err, _ = assert_same_topk(torch, q, big, kv, ki, pv, pi, "L2", RTOL["float32"])
            max_err = max(max_err, err)
            paths[nq][name] = cuda_ms(torch, lambda: F.flat_search(q, big, 10, **kw))
    del big, big_sq
    torch.cuda.empty_cache()
    return cases, max_err, paths


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


def slice_requests(docs):
    """The slice's requests: 8 documents' texts (their own doc is the
    expected top hit) and a 16-query batch."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    picks = [0, 3] + sorted(int(i) for i in rng.choice(
        np.arange(5, N_DOCS), size=6, replace=False))
    queries = [docs[i]["content"] for i in picks]
    batch_queries = [docs[int(i)]["content"]
                     for i in rng.choice(N_DOCS, size=15, replace=False)]
    batch_queries.append("how do sentence encoders pool token states")
    return picks, queries, batch_queries


def drive_slice(torch, cfg, docs, queries, batch_queries):
    """The slice's main path through ``RAGManager`` on the card: ingest the
    documents, the 8 requests, one 16-query ``search_batch`` and an answer,
    save, export the encoder's params, reload in a second manager and ask
    the 8 requests again. Returns what a phase checks."""
    import types

    from rag_faiss_embedding_tpu_torch.models import convert
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cuda = torch.device("cuda")
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
    return types.SimpleNamespace(
        manager=manager, reloaded=reloaded, engine=engine, n=n, ingest_s=ingest_s,
        latencies=latencies, singles=singles, singles2=singles2, batch=batch,
        batch_ms=batch_ms, answer=answer, searches=len(queries) * 2 + 1)


def check_slice(run, docs, picks, min_self_hits: int) -> int:
    """The checks every slice shares: all documents ingested, no empty
    answer, the reloaded manager answers the same, self-retrieval held for
    at least ``min_self_hits`` of the 8 requests (returned)."""
    if run.n != N_DOCS or run.manager.vector_store.ntotal != N_DOCS:
        raise AssertionError(f"ingested {run.n} of {N_DOCS} documents")
    if any(not hits for hits in run.singles + run.singles2 + run.batch):
        raise AssertionError("a request returned no documents")
    self_hits = sum(hits[0]["url"] == docs[i]["url"] for hits, i in zip(run.singles, picks))
    if self_hits < min_self_hits:
        raise AssertionError(f"self-retrieval held for {self_hits} of 8")
    for a, b in zip(run.singles, run.singles2):
        if not same_hits(a, b):
            raise AssertionError("the reloaded manager answers differently")
    if not run.answer:
        raise AssertionError("no answer generated")
    return self_hits


def check_against_cpu(torch, run, cpu_index, rows, queries, batch_queries, rtol):
    """The card index against the same saved index searched on the CPU:
    the 8 requests by their embeddings, and ``search_batch``'s hits mapped
    back to index rows, by ``assert_same_topk`` over ``rows``. Returns the
    embeddings and the id mismatches of both. The random-init encoder packs
    documents close together, so near-ties among the top 5 are common: ids
    may differ only where values tie."""
    index, embedder = run.manager.vector_store.index, run.manager.embedder
    card_emb = embedder.generate_embeddings(queries)
    card_v, card_i = index.search(card_emb, 5)
    cpu_v, cpu_i = cpu_index.search(card_emb, 5)
    _, top5_mismatch = assert_same_topk(
        torch, torch.from_numpy(card_emb), rows, card_v.cpu(), card_i.cpu(), cpu_v, cpu_i,
        "L2", rtol)
    batch_emb = embedder.generate_embeddings(batch_queries)
    cpu_bv, cpu_bi = cpu_index.search(batch_emb, 5)
    row_of = {d: p for p, d in enumerate(run.manager.vector_store.doc_ids)}
    hit_v = torch.tensor([[h["distance"] for h in hits] for hits in run.batch])
    hit_i = torch.tensor([[row_of[h["id"]] for h in hits] for hits in run.batch],
                         dtype=torch.int32)
    _, batch_mismatch = assert_same_topk(
        torch, torch.from_numpy(batch_emb), rows, hit_v, hit_i, cpu_bv, cpu_bi, "L2", rtol)
    return card_emb, batch_emb, top5_mismatch, batch_mismatch


def slice_summary(run, phase: str, self_hits: int, top5_mismatch: int,
                  batch_mismatch: int) -> dict:
    """The fields every slice phase reports."""
    return {"phase": phase, "documents": run.n, "ingest_s": run.ingest_s,
            "request_ms": run.latencies,
            "request_ms_median": statistics.median(run.latencies),
            "batch16_ms": run.batch_ms, "self_retrieval": f"{self_hits}/8",
            "searches": run.searches, "top5_id_mismatch_vs_cpu": top5_mismatch,
            "batch_top5_id_mismatch_vs_cpu": batch_mismatch,
            "answer_chars": len(run.answer)}


def slice_phase(torch, F, workdir: Path):
    import numpy as np

    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import FlatIndex
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline
    from rag_faiss_embedding_tpu_torch.models import convert

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    cfg = Config(base_dir=workdir, model_name="chip-smoke-random-init")
    picks, queries, batch_queries = slice_requests(docs)

    F.flat_search.launches = 0  # count the main path's launches only
    run = drive_slice(torch, cfg, docs, queries, batch_queries)
    launches = F.flat_search.launches

    self_hits = check_slice(run, docs, picks, 7)
    if launches < run.searches:
        raise AssertionError(f"kernel launched {launches} times for {run.searches} searches")
    manager, index = run.manager, run.manager.vector_store.index
    on_card = [index._buf.is_cuda, index._sq.is_cuda] + [
        p.is_cuda for p in manager.embedder.model.parameters()]
    if not all(on_card) or not run.reloaded.vector_store.index._buf.is_cuda:
        raise AssertionError("an index or encoder tensor is off the card")

    # the same pipeline on the CPU: embeddings, then the plain scan
    cpu_index = FlatIndex.from_state_dict(index.state_dict(), device="cpu")
    card_emb, batch_emb, top5_mismatch, batch_mismatch = check_against_cpu(
        torch, run, cpu_index, torch.from_numpy(cpu_index.vectors()), queries,
        batch_queries, RTOL["float32"])
    cpu_pipe = EmbeddingPipeline(
        params=convert.to_flax_params(manager.embedder.model.state_dict(),
                                      manager.embedder.cfg),
        cfg=manager.embedder.cfg, tokenizer=manager.embedder.tokenizer,
        device="cpu")
    emb_err = float(np.abs(card_emb - cpu_pipe.generate_embeddings(queries)).max())
    if emb_err > 1e-3:
        raise AssertionError(f"card vs CPU embeddings differ by {emb_err}")

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
    # a request for 100 hits (above the tiled path's KMAX): K1 serves it,
    # held to the CPU index
    before = F.flat_search.launches
    hits = run.engine.search(queries[0], top_k=100)
    k100_launches = F.flat_search.launches - before
    if len(hits) != 100 or k100_launches != 1:
        raise AssertionError(f"top_k=100 gave {len(hits)} hits through {k100_launches} "
                             f"kernel launches")
    q1 = manager.embedder.embed_query(queries[0])[None]
    kv, ki = index.search(q1, 100)
    cv, ci = cpu_index.search(q1, 100)
    k100_err, k100_mism = assert_same_topk(
        torch, torch.from_numpy(q1), torch.from_numpy(cpu_index.vectors()),
        kv.cpu(), ki.cpu(), cv, ci, "L2", RTOL["float32"])
    trace = trace_phase(torch, run.engine, queries, batch_queries)
    manager.cleanup()
    run.reloaded.cleanup()
    return trace, {
        **slice_summary(run, "slice", self_hits, top5_mismatch, batch_mismatch),
        "encoder": dataclasses.asdict(manager.embedder.cfg),
        "flat_scan_launches": launches, "embedding_max_abs_err_vs_cpu": emb_err,
        "main_path_kernel_times": shapes,
        "top_k_100": {"kernel_launches": k100_launches, "hits": len(hits),
                      "max_abs_err_vs_cpu": k100_err, "id_mismatch_vs_cpu": k100_mism},
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
        "device_ops_per_request": len(on_card) / n,
        # busy time against the untraced median; the traced wall is longer
        "idle_share": 1 - busy_ms / n / wall_ms if on_card else None,
        "idle_share_traced": 1 - busy_ms / traced_ms if on_card else None,
        "device_ms_per_request_by_kernel": [[name[:70], us / 1e3 / n] for name, us in top],
        "encoder_seq_bucket": int(ids.shape[1]),
        "encoder_ms_by_rows": encoder_ms,
    }


# ------------------------------------------------------------------ phase 6
def host_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def union_args(S, idx, q, k: int, variant: int, nprobe=None):
    """The union-scan call ``idx.search(q, k, nprobe)`` makes on the kernel
    route (same coarse stage, union and padding), and its dispatch."""
    saved, idx.nprobe = idx.nprobe, nprobe or idx.nprobe
    disp = idx.resolved_dispatch(q.shape[0], k)
    idx.nprobe = saved
    if disp["backend"] != "pallas" or disp["interpret"]:
        raise AssertionError(f"the index does not dispatch the kernel: {disp}")
    _, qp, u_all, _ = S._coarse_union(
        q.float(), idx._cent_store, idx._cent_sq, nprobe=disp["nprobe"],
        metric=idx.metric, union_cap=disp["union_cap"], qc=disp["qc"],
        union_mode=disp["union_mode"])
    args = S.union_scan_args(qp, u_all, idx._sorted_vecs, idx._sorted_sq,
                             idx._sorted_ids, k=k, window=idx._window,
                             metric=idx.metric, pallas_cap=idx.pallas_cap,
                             pallas_variant=variant)
    return args, disp


def slot_of_ids(torch, idx):
    """Block slot of every live row id of an IVF index."""
    ids = idx._sorted_ids
    live = torch.nonzero(ids >= 0).flatten()
    slot_of = torch.full((idx.ntotal,), -1, dtype=torch.long, device=ids.device)
    slot_of[ids[live].long()] = live
    return slot_of


def union_check(torch, U, idx, args, k: int):
    """One union-scan kernel call against its plain version on the same card
    tensors, both decoded to (scores, ids); returns (max_abs_err, ids that
    differ). Scores agree within rtol x (max ||q||^2 + max ||x||^2) + rtol x
    |score| plus two packing quanta (2^(nbits-22) x |score|: one float32 ulp
    of difference can move a truncated value by one quantum); missing slots
    agree; every kernel id carries its own float64 score, so ids differ only
    at near-ties."""
    window = args["window"]

    def decode(out):
        if args["ktop"]:
            return U.decode_selected(out[0], out[1], args["u_all"],
                                     args["sorted_ids"], window=window, k=k)
        return U.decode_topk(out, args["u_all"], args["sorted_ids"],
                             window=window, k=k)

    kv, ki = decode(U.union_scan(**args))
    torch.cuda.synchronize()
    pv, pi = decode(U.union_scan_reference(**args))
    q = args["qs"].reshape(kv.shape[0], -1).double()
    rtol = RTOL["bfloat16" if args["qs"].dtype == torch.bfloat16 else "float32"]
    sq = args["sorted_sq"]
    atol = rtol * float((q * q).sum(1).max() + sq[args["sorted_ids"] >= 0].max())
    quantum = 2.0 ** (U.packing_bits(args["u_all"].shape[1]) - 22)
    if not torch.equal(ki >= 0, pi >= 0):
        raise AssertionError("kernel and plain union scans fill different slots")
    ok = ki >= 0
    diff = (kv - pv).abs()[ok]
    err = float(diff.max()) if ok.any() else 0.0
    if not bool((diff <= atol + (rtol + quantum) * pv.abs()[ok]).all()):
        raise AssertionError(f"union-scan scores differ by {err}")
    slots = slot_of_ids(torch, idx)[ki.clamp_min(0).long()]
    x = idx._sorted_vecs[slots].double()
    true = 2.0 * (q[:, None, :] * x).sum(-1) - sq[slots].double()
    if not bool(((true - kv.double()).abs()[ok]
                 <= atol + (rtol + quantum) * true.abs()[ok]).all()):
        raise AssertionError("union-scan ids do not carry their scores")
    return err, int((ki != pi).sum())


def scan_work(torch, qs, u_all, ids2, nq: int, out_bytes: int) -> dict:
    """What a union-block scan over (chunks, qc, D) queries ``qs``, of which
    the first ``nq`` are real (the rest copies that pad the last chunk), and
    blocks of ids ``ids2`` (blocks, window) must do: the bytes it moves
    (each distinct block's rows, norms and ids read once, the real queries
    and the union read, ``out_bytes`` written) and its operations (a
    multiply and an add per dimension for each real query of a chunk and
    each live row of the chunk's distinct blocks: the sentinel block and
    dead rows need none), with the storage dtype whose peak rate applies."""
    chunks, qc, d = qs.shape
    item = qs.element_size()
    blocks = int(torch.unique(u_all).numel())
    live = (ids2 >= 0).sum(1)
    pairs = sum(min(max(nq - c * qc, 0), qc) * int(live[torch.unique(u_all[c]).long()].sum())
                for c in range(chunks))
    return {"bytes": blocks * ids2.shape[1] * (d * item + 8) + nq * d * item
            + u_all.numel() * 4 + out_bytes,
            "flops": 2 * pairs * d, "dtype": str(qs.dtype).removeprefix("torch.")}


def union_work(torch, U, args, nq: int) -> dict:
    """``scan_work`` of one union-scan call for ``nq`` real queries."""
    chunks, qc, _ = args["qs"].shape
    lanes = 2 * U.KPAD if args["ktop"] else args["cap"] * args["window"]
    return scan_work(torch, args["qs"], args["u_all"],
                     args["sorted_ids"].view(-1, args["window"]), nq, chunks * qc * lanes * 4)


def flat_work(q: int, n: int, d: int, k: int) -> dict:
    """What the exact float32 flat scan of ``q`` queries over ``n`` rows of
    ``d`` must do: rows, norms and queries read once, (values, ids) of the
    top ``k`` written; a multiply and an add per query, row and dimension."""
    return {"bytes": n * (d + 1) * 4 + q * d * 4 + q * k * 8, "flops": 2 * q * n * d,
            "dtype": "float32"}


def search_profile(torch, idx, q, reps: int) -> dict:
    """``torch.profiler`` over ``reps`` warm ``idx.search(q, 10)`` calls:
    traced wall and device busy time per search, the idle share, and the
    device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx.search(q, 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            idx.search(q, 10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms, by_name = device_busy_ms(on_card)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"traced_ms_per_search": wall_ms, "device_busy_ms_per_search": busy_ms / reps,
            "device_ops_per_search": len(on_card) / reps,
            "idle_share_traced": 1 - busy_ms / reps / wall_ms,
            "device_ms_per_search_by_kernel": [[n[:70], us / 1e3 / reps] for n, us in top]}


IVF_ROUTES = (("union_scan v1", "auto", 1), ("union_scan v2", "auto", 2),
              ("plain chunk body", "xla", 1))


def bench_rows(torch):
    """bench.py's IVF distribution, made on the card from a seeded
    generator: 1,048,576 x 384 rows (8,192 Gaussian modes, row = mode + 0.7
    noise) and 1,024 queries (a row + 0.3 noise)."""
    cuda = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    centers = randn(IVF_MODES, IVF_DIM)
    db = centers[torch.randint(0, IVF_MODES, (IVF_N,), generator=g, device=cuda)]
    db += 0.7 * randn(IVF_N, IVF_DIM)
    queries = db[torch.randint(0, IVF_N, (IVF_Q,), generator=g, device=cuda)]
    queries += 0.3 * randn(IVF_Q, IVF_DIM)
    torch.cuda.synchronize()
    return db, queries


def ivf_build(torch):
    """bench.py's 1M rows in ``IVFFlatIndex(384, nlist=8192,
    dtype="bfloat16", train_iters=10, balance="reassign")``: (index, build
    seconds, the 1,024 queries, their exact float32 top-10)."""
    from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex

    cuda = torch.device("cuda")
    db, queries = bench_rows(torch)
    t0 = time.perf_counter()
    idx = IVFFlatIndex(IVF_DIM, nlist=IVF_NLIST, dtype="bfloat16", train_iters=10,
                       balance="reassign", device=cuda)
    idx.build(db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    flat = FlatIndex(IVF_DIM, capacity=IVF_N, device=cuda)
    flat.add(db)
    _, truth = flat.search(queries, 10)  # exact float32 top-10
    del flat, db
    torch.cuda.empty_cache()
    return idx, build_s, queries, truth


def ivf_kernel_phase(torch, idx, build_s, queries, truth):
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops import union_scan as U

    single = queries[:64]

    U.union_scan.launches = 0  # count the path's launches only
    U.union_scan.variant_launches = {1: 0, 2: 0}
    routes = []
    for nprobe in (None, 16):
        for name, backend, variant in IVF_ROUTES:
            idx.backend, idx.pallas_variant = backend, variant
            ids1 = torch.cat([idx.search(single[i:i + 1], 10, nprobe=nprobe)[1]
                              for i in range(len(single))])
            _, ids = idx.search(queries, 10, nprobe=nprobe)
            routes.append({
                "route": name, "nprobe": nprobe or idx.nprobe,
                "recall@10_q1": recall_at(ids1, truth[:len(single)]),
                "recall@10_q1024": recall_at(ids, truth),
                "search_ms_q1": host_ms(torch, lambda: idx.search(single[:1], 10, nprobe=nprobe), 10),
                "search_ms_q1024": host_ms(torch, lambda: idx.search(queries, 10, nprobe=nprobe), 5),
            })
    torch.cuda.synchronize()
    launches = dict(U.union_scan.variant_launches)
    for i in range(0, len(routes), 3):
        plain = routes[i + 2]
        for r in routes[i:i + 2]:
            for key in ("recall@10_q1", "recall@10_q1024"):
                if r[key] < RECALL_MIN or r[key] < plain[key] - RECALL_SLACK:
                    raise AssertionError(f"{r['route']} nprobe {r['nprobe']} {key} "
                                         f"{r[key]} (plain {plain[key]})")

    # where a search's time goes: host wall vs device busy, by kernel
    idx.backend, idx.pallas_variant = "auto", 1
    profiles = {f"Q={q.shape[0]}": search_profile(torch, idx, q, reps)
                for q, reps in ((single[:1], 8), (queries, 3))}

    # each kernel against its plain version at the path's shapes
    cases, max_err = [], {1: 0.0, 2: 0.0}
    for nprobe in (None, 16):
        for nq in (1, IVF_Q):
            for variant in (1, 2):
                args, disp = union_args(S, idx, queries[:nq], 10, variant, nprobe)
                err, mism = union_check(torch, U, idx, args, 10)
                max_err[variant] = max(max_err[variant], err)
                cases.append({
                    "variant": variant, "Q": nq, "nprobe": disp["nprobe"],
                    "union_mode": disp["union_mode"], "chunks": args["qs"].shape[0],
                    "qc": args["qs"].shape[1], "U": args["u_all"].shape[1],
                    "window": args["window"], "ktop": args["ktop"],
                    "max_abs_err": err, "id_mismatch": mism,
                    **union_work(torch, U, args, nq),
                    "ms": cuda_ms(torch, lambda: U.union_scan(**args)),
                    "plain_ms": cuda_ms(torch, lambda: U.union_scan_reference(**args)),
                })

    # edges: removed rows stay out under variant 2; k past the candidates
    idx.pallas_variant = 2
    _, before = idx.search(queries[:8], 3)
    kill = torch.unique(before[:, 0])
    idx.remove_ids(kill.cpu().numpy())
    _, after = idx.search(queries[:8], 10)
    if bool(torch.isin(after, kill).any()):
        raise AssertionError("a removed row came back under variant 2")
    # the bins hold cap x window candidates; the spill tier adds its rows
    n_cand = idx.pallas_cap * idx._window + idx._pending.ntotal
    wide_v, wide = idx.search(queries[:4], n_cand + 88, nprobe=1)
    if not (bool((wide[:, n_cand:] == -1).all()) and bool((wide[:, 0] >= 0).all())
            and bool(torch.isinf(wide_v[:, n_cand:]).all())):
        raise AssertionError("k past the candidates must pad with -1 / inf")
    return {
        "phase": "ivf_kernel", "N": IVF_N, "D": IVF_DIM, "nlist": idx.nlist,
        "dtype": "bfloat16", "build_s": build_s,
        "build_stats": {k: v for k, v in idx.build_stats.items() if k != "train"},
        "train_stats": idx.build_stats.get("train"),
        "window": idx._window, "spill_rows": idx._n_spill,
        "resolved_dispatch_q1": idx.resolved_dispatch(1),
        "resolved_dispatch_q1024": idx.resolved_dispatch(IVF_Q),
        "routes": routes, "path_launches": launches, "kernel_cases": cases,
        "search_profile_v1": profiles,
        "removed": int(kill.numel()), "k_past_candidates": n_cand + 88,
    }, max_err


# ------------------------------------------------------------------ phase 7
def ivf_slice_phase(torch, workdir: Path):
    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops import union_scan as U

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    cfg = Config(base_dir=workdir, model_name="chip-smoke-random-init",
                 index_kind="ivf", ivf_nlist=64)
    picks, queries, batch_queries = slice_requests(docs)

    U.union_scan.launches = 0  # count the main path's launches only
    U.union_scan.variant_launches = {1: 0, 2: 0}
    run = drive_slice(torch, cfg, docs, queries, batch_queries)
    launches = U.union_scan.variant_launches[1]

    index = run.manager.vector_store.index
    if not isinstance(index, IVFFlatIndex) or not isinstance(
            run.reloaded.vector_store.index, IVFFlatIndex):
        raise AssertionError("the ivf manager did not build an IVFFlatIndex")
    self_hits = check_slice(run, docs, picks, 7)
    if launches < run.searches:
        raise AssertionError(f"union scan launched {launches} times for {run.searches} searches")
    tensors = [index._sorted_vecs, index._sorted_sq, index._sorted_ids, index._cent_store,
               index._cent_sq, index.centroids, index._pending._buf,
               run.reloaded.vector_store.index._sorted_vecs]
    if not all(t.is_cuda for t in tensors) or not all(
            p.is_cuda for p in run.manager.embedder.model.parameters()):
        raise AssertionError("an index or encoder tensor is off the card")

    # the same saved index on the CPU, through the kernel's plain version
    cpu_index = IVFFlatIndex.from_state_dict(index.state_dict(), device="cpu",
                                             backend="pallas")
    card_emb, batch_emb, top5_mismatch, batch_mismatch = check_against_cpu(
        torch, run, cpu_index, torch.from_numpy(cpu_index.vectors()), queries,
        batch_queries, RTOL["float32"])

    # the kernel against its plain version at the path's shapes
    shapes, max_err = {}, 0.0
    for emb in (card_emb[:1], batch_emb):
        q = torch.from_numpy(emb).to(cuda)
        args, disp = union_args(S, index, q, 5, 1)
        err, mism = union_check(torch, U, index, args, 5)
        max_err = max(max_err, err)
        shapes[f"Q={q.shape[0]}"] = {
            "chunks": args["qs"].shape[0], "qc": args["qs"].shape[1],
            "U": args["u_all"].shape[1], "window": args["window"], "D": index.dim,
            "k": 5, "nprobe": disp["nprobe"], "max_abs_err": err, "id_mismatch": mism,
            **union_work(torch, U, args, q.shape[0]),
            "ms": cuda_ms(torch, lambda: U.union_scan(**args)),
            "plain_ms": cuda_ms(torch, lambda: U.union_scan_reference(**args)),
        }
    trace = trace_phase(torch, run.engine, queries, batch_queries)
    trace["phase"] = "ivf_trace"
    run.manager.cleanup()
    run.reloaded.cleanup()
    return trace, {
        **slice_summary(run, "ivf_slice", self_hits, top5_mismatch, batch_mismatch),
        "nlist": index.nlist, "window": index._window, "spill_rows": index._n_spill,
        "resolved_dispatch_q1": index.resolved_dispatch(1),
        "union_scan_v1_launches": launches, "main_path_kernel_times": shapes,
        "max_abs_err": max_err,
    }


# ------------------------------------------------------------------ phase 8
PQ_ROUTES = (("pq_decode kernel", "auto"), ("plain decode", "xla"))
PQ_DECODE_COLUMNS = ["D", "M", "ksub", "dtype", "N", "groups", "max_abs_err", "ms",
                     "plain_ms"]


def decode_check(torch, PD, cb, codes):
    """K4 against ``decode_reference`` on the same card tensors, compared as
    raw bits; returns (max_abs_err, ms, plain_ms)."""
    out = PD.decode(cb, codes)
    torch.cuda.synchronize()
    ref = PD.decode_reference(cb, codes)
    bits = torch.int16 if cb.dtype == torch.bfloat16 else torch.int32
    if (out.dtype != ref.dtype or out.shape != ref.shape
            or not torch.equal(out.view(bits), ref.view(bits))):
        raise AssertionError(f"pq_decode differs from its plain version: codes "
                             f"{tuple(codes.shape)}, codebook {tuple(cb.shape)} {cb.dtype}")
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    del out, ref
    return (err, cuda_ms(torch, lambda: PD.decode(cb, codes)),
            cuda_ms(torch, lambda: PD.decode_reference(cb, codes)))


def decode_library(torch, PD, cb, codes) -> dict:
    """The one PyTorch call that computes K4's function, timed on the same
    inputs (the index into the flattened codebook made outside the timing;
    the call must return K4's bits), and the bytes the decode must move."""
    import torch.nn.functional as Fn

    m, ksub, dsub = cb.shape
    flat = codes.long() + torch.arange(m, device=codes.device) * ksub
    table = cb.reshape(m * ksub, dsub)
    if not torch.equal(Fn.embedding(flat, table).reshape(codes.shape[0], m * dsub),
                       PD.decode(cb, codes)):
        raise AssertionError("F.embedding does not compute the PQ decode")
    return {"library_ms": cuda_ms(torch, lambda: Fn.embedding(flat, table)),
            "bytes": codes.numel() * (1 + dsub * cb.element_size())
            + cb.numel() * cb.element_size()}


def pq_decode_grid(torch, PD):
    """K4 over D = 384 with M 16 / 48 / 96 and D = 768 with M 96, ksub 16 and
    256, bf16 and f32 codebooks, N from 0 to 1,048,576; at 1,048,576 rows of
    M 48 ksub 256 bf16 also its one-call library equivalent."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases, max_err, at_1m = [], 0.0, None
    for d, m in ((384, 16), (384, 48), (384, 96), (768, 96)):
        for ksub in (16, 256):
            for dtype in (torch.bfloat16, torch.float32):
                cb = torch.randn((m, ksub, d // m), generator=g, device="cuda").to(dtype)
                for n in (0, 1, 127, 4096, 1 << 20):
                    codes = torch.randint(0, ksub, (n, m), generator=g,
                                          device="cuda").to(torch.uint8)
                    err, ms, plain_ms = decode_check(torch, PD, cb, codes)
                    max_err = max(max_err, err)
                    cases.append([d, m, ksub, str(dtype).removeprefix("torch."), n,
                                  PD.plan(m, ksub, d // m, dtype)["groups"], err, ms,
                                  plain_ms])
                    if (d, m, ksub, dtype, n) == (384, 48, 256, torch.bfloat16, 1 << 20):
                        at_1m = {"ms": ms, "plain_ms": plain_ms,
                                 **decode_library(torch, PD, cb, codes)}
    torch.cuda.empty_cache()
    return cases, max_err, at_1m


def pq_path_codes(S, idx, q, nprobe=None):
    """The codes the PQ chunk body of ``idx.search(q, k, nprobe)`` decodes in
    its first union segment of its first query chunk, with the dispatch and
    the union segment count."""
    saved, idx.nprobe = idx.nprobe, nprobe or idx.nprobe
    disp = idx.resolved_dispatch(q.shape[0])
    idx.nprobe = saved
    _, _, u_all, _ = S._coarse_union(
        q.float(), idx._cent_store, idx._cent_sq, nprobe=disp["nprobe"],
        metric=idx.metric, union_cap=disp["union_cap"], qc=disp["qc"],
        union_mode=disp["union_mode"])
    useg = S._pq_union_segments(u_all.shape[1], idx._window, idx.pq_m, idx.dim, disp["qc"])
    seg = -(-u_all.shape[1] // useg)
    codes3 = idx._sorted_vecs.view(-1, idx._window, idx.pq_m)
    return codes3[u_all[0, :seg].long()].reshape(-1, idx.pq_m), disp, useg


def pq_routes(torch, idx, queries, truth, nprobe=None):
    """``idx.search`` at k = 10, Q = 1 (64 single queries) and Q = 1,024
    through the kernel and the plain decode. The two routes must return the
    same bits (the same decoded values feed the same product). One row per
    route: recall@10 against ``truth`` and host-clock search times."""
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at

    kw = {} if nprobe is None else {"nprobe": nprobe}
    single = queries[:64]
    rows, outs = [], []
    for name, backend in PQ_ROUTES:
        idx.backend = backend
        ones = [idx.search(single[i:i + 1], 10, **kw) for i in range(len(single))]
        v, i = idx.search(queries, 10, **kw)
        outs.append((torch.cat([o[0] for o in ones]), torch.cat([o[1] for o in ones]), v, i))
        rows.append({
            "route": name, "nprobe": nprobe,
            "recall@10_q1": recall_at(outs[-1][1], truth[:len(single)]),
            "recall@10_q1024": recall_at(i, truth),
            "search_ms_q1": host_ms(torch, lambda: idx.search(single[:1], 10, **kw), 10),
            "search_ms_q1024": host_ms(torch, lambda: idx.search(queries, 10, **kw), 5),
        })
    idx.backend = "auto"
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"kernel and plain decode routes disagree (nprobe {nprobe})")
    v, i = outs[0][2], outs[0][3]
    if not (bool((i >= 0).all()) and bool(torch.isfinite(v).all())
            and bool((v[:, 1:] >= v[:, :-1]).all())):
        raise AssertionError("a Q = 1,024 search returned missing or unsorted slots")
    return rows


def pq_kernel_phase(torch):
    from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex, PQIndex
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD

    cuda = torch.device("cuda")
    grid, max_err, at_1m = pq_decode_grid(torch, PD)
    db, queries = bench_rows(torch)
    flat = FlatIndex(IVF_DIM, capacity=IVF_N, device=cuda)
    flat.add(db)
    _, truth = flat.search(queries, 10)  # exact float32 top-10
    del flat
    torch.cuda.empty_cache()

    PD.decode.launches = 0  # count the path's launches only
    built = {}
    ivf_kw = dict(nlist=IVF_NLIST, pq_m=48, balance="reassign", train_iters=10, device=cuda)
    for name, make in (
            ("pq", lambda: PQIndex(IVF_DIM, m=48, device=cuda)),
            ("ivf_pq", lambda: IVFFlatIndex(IVF_DIM, **ivf_kw)),
            ("ivf_pq_refine", lambda: IVFFlatIndex(IVF_DIM, rerank=True, **ivf_kw))):
        idx = make()
        if name == "ivf_pq_refine":  # the same IVF-PQ: its coarse quantizer and codec
            base = built["ivf_pq"][0]
            idx.centroids, idx.is_trained = base.centroids, True
            idx.pq_codebooks = base.pq_codebooks
        t0 = time.perf_counter()
        idx.build(db)
        torch.cuda.synchronize()
        built[name] = (idx, time.perf_counter() - t0)
    del db
    torch.cuda.empty_cache()

    indexes, cases = [], []
    for name, (idx, build_s) in built.items():
        entry = {"index": name, "build_s": build_s}
        if name == "pq":
            entry.update(m=idx.m, ksub=idx.ksub, compute=idx.compute_dtype,
                         routes=pq_routes(torch, idx, queries, truth))
            cb = idx.codebooks.to(torch.bfloat16)
            for start in (0, 1 << 19):  # the scan's two 524,288-row chunks
                codes = idx._codes[start:start + (1 << 19)]
                err, ms, plain_ms = decode_check(torch, PD, cb, codes)
                max_err = max(max_err, err)
                cases.append({"index": name, "Q": "any", "rows": codes.shape[0],
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        else:
            useg_probe = None
            for nprobe in (32, 64, 128, 256, 512):
                if pq_path_codes(S, idx, queries, nprobe)[2] > 1:
                    useg_probe = nprobe
                    break
            if useg_probe is None:
                raise AssertionError("no nprobe up to 512 segments the PQ union")
            routes = []
            for nprobe in (8, useg_probe):
                routes += pq_routes(torch, idx, queries, truth, nprobe)
                for nq in (1, IVF_Q):
                    codes, disp, useg = pq_path_codes(S, idx, queries[:nq], nprobe)
                    err, ms, plain_ms = decode_check(torch, PD, idx._pq_cb_compute(), codes)
                    max_err = max(max_err, err)
                    cases.append({"index": name, "Q": nq, "nprobe": nprobe, "qc": disp["qc"],
                                  "union_cap": disp["union_cap"], "useg": useg,
                                  "rows": codes.shape[0], "max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms})
            entry.update(window=idx._window, spill_rows=idx._n_spill,
                         rerank=idx.rerank, refine_dtype=idx.refine_dtype,
                         rerank_depth=idx.rerank_depth, useg_nprobe=useg_probe,
                         build_stats={k: v for k, v in idx.build_stats.items() if k != "train"},
                         train_stats=idx.build_stats.get("train"),
                         resolved_dispatch_q1024=idx.resolved_dispatch(IVF_Q), routes=routes)
        entry["search_profile"] = {f"Q={q.shape[0]}": search_profile(torch, idx, q, reps)
                                   for q, reps in ((queries[:1], 8), (queries, 3))}
        indexes.append(entry)
    torch.cuda.synchronize()
    launches = PD.decode.launches
    if launches == 0:
        raise AssertionError("the PQ indexes never launched pq_decode")
    return {"phase": "pq_kernel", "N": IVF_N, "D": IVF_DIM, "decode_columns": PQ_DECODE_COLUMNS,
            "decode_cases": grid, "decode_1M_M48_bf16": at_1m, "indexes": indexes,
            "path_cases": cases,
            "path_launches": launches}, max_err


# ------------------------------------------------------------------ phase 9
def pq_slice_run(torch, workdir: Path, label: str, **index_kw):
    """One PQ manager over the slice's documents and requests, checked
    against the saved index searched on the CPU through the plain decode.
    Each returned id must carry its own ADC distance, recomputed in float64
    against the decoded reconstruction (rtol 1e-3: bf16 compute). The codec
    blurs near neighbours, so self-retrieval is recorded, not gated."""
    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, PQIndex
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    cfg = Config(base_dir=workdir, model_name="chip-smoke-random-init", **index_kw)
    picks, queries, batch_queries = slice_requests(docs)

    PD.decode.launches = 0  # count the main path's launches only
    run = drive_slice(torch, cfg, docs, queries, batch_queries)
    launches = PD.decode.launches

    index = run.manager.vector_store.index
    is_ivf = label == "ivf_pq"
    want = (IVFFlatIndex, 48) if is_ivf else (PQIndex, None)
    if not (isinstance(index, want[0]) and isinstance(run.reloaded.vector_store.index, want[0])
            and getattr(index, "pq_m", None) == want[1]):
        raise AssertionError(f"the {label} manager did not build its PQ index")
    self_hits = check_slice(run, docs, picks, 0)
    if launches < run.searches:
        raise AssertionError(f"pq_decode launched {launches} times for {run.searches} searches")
    if is_ivf:
        tensors = [index._sorted_vecs, index._sorted_sq, index._sorted_ids,
                   index._cent_store, index.pq_codebooks, index._pending._buf,
                   run.reloaded.vector_store.index._sorted_vecs]
    else:
        tensors = [index._codes, index._sq, index.codebooks,
                   run.reloaded.vector_store.index._codes]
    if not all(t.is_cuda for t in tensors) or not all(
            p.is_cuda for p in run.manager.embedder.model.parameters()):
        raise AssertionError("an index or encoder tensor is off the card")

    # the same saved index on the CPU, through the plain decode; the rows a
    # result is checked against are its reconstructions
    cpu_index = type(index).from_state_dict(index.state_dict(), device="cpu", backend="xla")
    if is_ivf:
        rec, rec_ids = cpu_index.vectors(return_ids=True)
        if rec_ids.tolist() != list(range(N_DOCS)):
            raise AssertionError("the IVF-PQ index lost a row")
    else:
        rec = cpu_index.vectors()
    card_emb, batch_emb, top5_mismatch, batch_mismatch = check_against_cpu(
        torch, run, cpu_index, torch.from_numpy(rec), queries, batch_queries,
        RTOL["bfloat16"])

    # the kernel against its plain version at the path's shapes
    shapes, max_err = {}, 0.0
    for emb in (card_emb[:1], batch_emb):
        q = torch.from_numpy(emb).to(cuda)
        if is_ivf:
            codes, disp, useg = pq_path_codes(S, index, q)
            cb, extra = index._pq_cb_compute(), {"qc": disp["qc"], "useg": useg,
                                                 "union_cap": disp["union_cap"],
                                                 "window": index._window}
        else:
            codes = index._codes[:min(524288, index._capacity)]
            cb, extra = index.codebooks.to(torch.bfloat16), {}
        err, ms, plain_ms = decode_check(torch, PD, cb, codes)
        max_err = max(max_err, err)
        shapes[f"Q={q.shape[0]}"] = {"rows": codes.shape[0], "M": codes.shape[1],
                                     "dtype": str(cb.dtype).removeprefix("torch."),
                                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     **decode_library(torch, PD, cb, codes), **extra}
    trace = trace_phase(torch, run.engine, queries, batch_queries)
    trace["phase"] = f"{label}_trace"
    run.manager.cleanup()
    run.reloaded.cleanup()
    out = {**slice_summary(run, label, self_hits, top5_mismatch, batch_mismatch),
           "index_kind": cfg.index_kind, "pq_decode_launches": launches,
           "main_path_kernel_times": shapes, "max_abs_err": max_err}
    if is_ivf:
        out.update(nlist=index.nlist, pq_m=index.pq_m, window=index._window,
                   spill_rows=index._n_spill, resolved_dispatch_q1=index.resolved_dispatch(1))
    else:
        out.update(m=index.m, compute=index.compute_dtype)
    return trace, out


def pq_slice_phase(torch):
    """``RAGManager(index_kind="pq")``, then ``RAGManager(index_kind="ivf",
    ivf_nlist=64, ivf_pq_m=48)``, each in a fresh directory."""
    out, traces = {"phase": "pq_slice"}, []
    for label, kw in (("pq", dict(index_kind="pq")),
                      ("ivf_pq", dict(index_kind="ivf", ivf_nlist=64, ivf_pq_m=48))):
        with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
            trace, out[label] = pq_slice_run(torch, Path(workdir), label, **kw)
        traces.append(trace)
    out["pq_decode_launches"] = sum(out[k]["pq_decode_launches"] for k in ("pq", "ivf_pq"))
    return traces, out


# ----------------------------------------------------------------- phase 10
def bound(bytes_moved: float, flops: float, dtype: str):
    """The least time the card could take for the work, in ms, and what
    bounds it: bytes over HBM_BYTES_PER_S or operations over the peak rate
    of the unit the exact result needs (PEAK_FLOPS)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def block_topk_check(torch, FP, args, kp: int):
    """K5 against its plain version on the same card tensors; returns
    (max |score| difference over live slots, ids that differ). The tensor
    cores sum the exact bf16 products in another order than the plain
    version, so: the same slots filled (NEG_INF / -1 past a cell's live
    rows), scores within rtol x (max ||q||^2 + max ||x||^2) + rtol x |score|,
    lists sorted with an id once each, and every kernel id carrying its own
    float64 score (so ids differ only at near-ties)."""
    from rag_faiss_embedding_tpu_torch.ops.distance import NEG_INF

    kv, ki = FP.block_topk(**args, kp=kp)
    torch.cuda.synchronize()
    pv, pi = FP.block_topk_reference(**args, kp=kp)
    q, ids2 = args["qs"].double(), args["ids2"]
    rtol = RTOL_EXACT_PRODUCTS
    atol = rtol * float((q * q).sum(-1).max() + args["sq2"][ids2 >= 0].max())
    ok = ki >= 0
    if not (torch.equal(ok, pi >= 0) and bool((kv[~ok] == NEG_INF).all())):
        raise AssertionError(f"block_topk fills other slots than its plain version (kp {kp})")
    diff = (kv - pv).abs()[ok]
    err = float(diff.max()) if ok.any() else 0.0
    if not bool((diff <= atol + rtol * pv.abs()[ok]).all()):
        raise AssertionError(f"block_topk scores differ by {err} (kp {kp})")
    srt = torch.where(ok, ki, -1 - torch.arange(kp, device=ki.device, dtype=ki.dtype))
    srt = srt.sort(-1).values
    if not (bool((srt[..., 1:] != srt[..., :-1]).all())
            and bool((kv[..., 1:] <= kv[..., :-1]).all())):
        raise AssertionError(f"block_topk lists repeat an id or are unsorted (kp {kp})")
    flat = ids2.reshape(-1)
    live = torch.nonzero(flat >= 0).flatten()
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.long, device=flat.device)
    slot_of[flat[live].long()] = live  # a spill row's copies are the same row
    rows = args["codes3"].reshape(flat.shape[0], -1)
    sq = args["sq2"].reshape(-1)
    for c in range(kv.shape[0]):
        slot = slot_of[ki[c].clamp_min(0).long()]
        own = 2.0 * (q[c][None, :, None, :] * rows[slot].double()).sum(-1) - sq[slot].double()
        bad = ((own - kv[c].double()).abs() > atol + rtol * own.abs()) & ok[c]
        if bool(bad.any()):
            raise AssertionError(f"block_topk ids do not carry their scores (kp {kp})")
    return err, int((ki != pi).sum())


def proto_search_check(torch, idx, queries, kernel, plain):
    """The prototype search through K5 against it through the plain version:
    the same slots filled, distances within rtol x (max ||q||^2 + max ||x||^2)
    + rtol x |distance|, and every id of the kernel route carrying its own
    float64 distance to its stored bf16 row (||q||^2 - 2 bf16(q).x + ||x||^2,
    the prototype's own arithmetic), so ids differ only at near-ties.
    Returns (max distance difference, ids that differ)."""
    (kv, ki), (pv, pi) = kernel, plain
    if not (torch.equal(ki >= 0, pi >= 0) and bool((ki >= 0).all())):
        raise AssertionError("the prototype search left slots empty")
    rtol = RTOL_EXACT_PRODUCTS
    q = queries.double()
    live_sq = idx._sorted_sq[idx._sorted_ids >= 0]
    atol = rtol * float((q * q).sum(1).max() + live_sq.max())
    err = float((kv - pv).abs().max())
    if not bool(((kv - pv).abs() <= atol + rtol * pv.abs()).all()):
        raise AssertionError(f"prototype search distances differ by {err}")
    slots = slot_of_ids(torch, idx)[ki.long()]
    x = idx._sorted_vecs[slots].double()
    qb = queries.bfloat16().double()
    own = ((q * q).sum(1)[:, None] - 2.0 * (qb[:, None, :] * x).sum(-1)
           + idx._sorted_sq[slots].double()).clamp_min(0)
    if not bool(((own - kv.double()).abs() <= atol + rtol * own.abs()).all()):
        raise AssertionError("prototype search ids do not carry their distances")
    return err, int((ki != pi).sum())


def fused_proto_phase(torch, idx, queries, truth):
    """The prototype search (``benchmarks.fused_proto.search``: UCAP = QC =
    256, BB 16, KP 10, k 10) over the 1M index at Q = 1,024, through K5 and
    through its plain version; K5 against the plain version at the path's
    shapes and at edge cases; CUDA-event times."""
    from rag_faiss_embedding_tpu_torch.benchmarks import fused_proto as BF
    from rag_faiss_embedding_tpu_torch.ops import fused_proto as FP

    FP.block_topk.launches = 0  # count the path's launches only
    vals, ids = BF.search(queries, idx)
    torch.cuda.synchronize()
    launches = FP.block_topk.launches
    if launches == 0:
        raise AssertionError("the prototype search never launched block_topk")
    pvals, pids = BF.search(queries, idx, cell_topk=FP.block_topk_reference)
    routes = {"kernel": BF.recall_at(ids, truth), "plain": BF.recall_at(pids, truth)}
    for name, rec in routes.items():
        if rec < RECALL_MIN or rec < routes["plain"] - RECALL_SLACK:
            raise AssertionError(f"prototype search through the {name} route: recall@10 "
                                 f"{rec} (plain {routes['plain']})")
    if not (ids.shape == (IVF_Q, 10) and bool((ids >= 0).all())
            and bool(torch.isfinite(vals).all()) and bool((vals[:, 1:] >= vals[:, :-1]).all())):
        raise AssertionError("the prototype search returned missing or unsorted slots")
    search_err, search_mism = proto_search_check(torch, idx, queries, (vals, ids),
                                                 (pvals, pids))

    # K5 against its plain version: the path's shapes, kp 1 and the largest,
    # a cell with fewer than kp live rows, the same row twice in one cell
    _, _, args = BF.cell_args(queries, idx)
    cases, max_err = [], 0.0
    for kp in (BF.KP, 1, FP.KP_MAX):
        err, mism = block_topk_check(torch, FP, args, kp)
        max_err = max(max_err, err)
        cases.append({"case": "path", "kp": kp, "max_abs_err": err, "id_mismatch": mism})
    cell = args["u_all"][0, :BF.BB].long()
    sparse = dict(args, ids2=args["ids2"].clone())
    sparse["ids2"][cell] = -1
    sparse["ids2"][cell[1], :3] = torch.arange(3, dtype=torch.int32, device="cuda") + idx.ntotal
    kv, ki = FP.block_topk(**sparse, kp=BF.KP)
    if not bool(((ki[0, 0] >= 0).sum(-1) == 3).all()):
        raise AssertionError("a cell with 3 live rows must return 3 ids per query")
    err, mism = block_topk_check(torch, FP, sparse, BF.KP)
    max_err = max(max_err, err)
    cases.append({"case": "3 live rows in a cell", "kp": BF.KP, "max_abs_err": err,
                  "id_mismatch": mism})
    a = next(int(x) for x in cell if bool((args["ids2"][x] >= 0).any()))
    b = next(int(x) for x in cell if int(x) != a)
    live = int(torch.nonzero(args["ids2"][a] >= 0)[0])
    dup = dict(args, codes3=args["codes3"].clone(), sq2=args["sq2"].clone(),
               ids2=args["ids2"].clone())
    dup["codes3"][a, live] = args["qs"][0, 0]  # close to chunk 0's first query
    dup["sq2"][a, live] = dup["codes3"][a, live].float().pow(2).sum()
    for name in ("codes3", "sq2", "ids2"):
        dup[name][b, 5] = dup[name][a, live]
    kv, ki = FP.block_topk(**dup, kp=BF.KP)
    twice = int(dup["ids2"][a, live])
    if int(ki[0, 0, 0, 0]) != twice or bool(((ki == twice).sum(-1) > 1).any()):
        raise AssertionError("a row twice in one cell must come back once")
    err, mism = block_topk_check(torch, FP, dup, BF.KP)
    max_err = max(max_err, err)
    cases.append({"case": "same row twice in a cell", "kp": BF.KP, "max_abs_err": err,
                  "id_mismatch": mism})
    del sparse, dup
    torch.cuda.empty_cache()

    chunks, qc, _ = args["qs"].shape
    work = scan_work(torch, args["qs"], args["u_all"], args["ids2"], chunks * qc,
                     chunks * (BF.UCAP // BF.BB) * qc * BF.KP * 8)
    idx.backend, idx.pallas_variant = "auto", 1
    return {
        "phase": "fused_proto", "N": IVF_N, "D": IVF_DIM, "nlist": idx.nlist,
        "window": idx._window, "Q": IVF_Q, "ucap": BF.UCAP, "qc": BF.QC, "bb": BF.BB,
        "kp": BF.KP, "k": BF.K, "recall@10": routes, "path_launches": launches,
        "tensor_cores": FP.uses_tensor_cores(torch.cuda.current_device(), IVF_DIM),
        "search_max_abs_err": search_err, "search_id_mismatch": search_mism,
        "kernel_cases": cases, "max_abs_err": max_err, "rtol": RTOL_EXACT_PRODUCTS,
        "atol": RTOL_EXACT_PRODUCTS * float(
            (args["qs"].double() ** 2).sum(-1).max() + args["sq2"][args["ids2"] >= 0].max()),
        **work, **work_bound(work),
        "ms": cuda_ms(torch, lambda: FP.block_topk(**args, kp=BF.KP)),
        "plain_ms": cuda_ms(torch, lambda: FP.block_topk_reference(**args, kp=BF.KP), 3, 1),
        "search_ms": cuda_ms(torch, lambda: BF.search(queries, idx)),
        "plain_search_ms": cuda_ms(
            torch, lambda: BF.search(queries, idx, cell_topk=FP.block_topk_reference), 3, 1),
        "ivf_search_k2_ms": cuda_ms(torch, lambda: idx.search(queries, 10)),
    }


def probe_check(torch, KP, variant: str, inputs: dict, kw: dict):
    """One K6 variant against its plain version on the same card tensors;
    returns (kernel bins, max |value| difference, bins that differ). The
    tensor cores sum the exact bf16 products in another order than the plain
    version, so: bins that read as a float NaN (a negative-subnormal score
    under temps_f32) are the same bins with the same bits; empty bins agree;
    values within rtol x (max ||q||^2 + max ||x||^2) + (rtol + two packing
    quanta) x |value|; and every kernel value carries its own block's
    float64 score for its (query, slot), so block positions differ only at
    near-ties. ``none`` holds block U - 1 in every bin."""
    from rag_faiss_embedding_tpu_torch.ops.distance import NEG_INF
    from rag_faiss_embedding_tpu_torch.ops.union_scan import packing_bits, unmonotone_f32

    k = KP.probe(variant, **inputs, **kw)
    torch.cuda.synchronize()
    p = KP.probe_reference(variant, **inputs, **kw)
    u_all, qs, codes3, aux3 = (inputs[n] for n in ("u_all", "qs", "codes3", "aux3"))
    u, window = u_all.shape[1], codes3.shape[1]
    nbits = packing_bits(u)
    mask = (1 << nbits) - 1
    kn, pn = torch.isnan(k.view(torch.float32)), torch.isnan(p.view(torch.float32))
    if not (torch.equal(kn, pn) and torch.equal(k[kn], p[pn])):
        raise AssertionError(f"probe {variant}: the NaN bins differ from the plain version's")
    kv, kb = unmonotone_f32(k & ~mask), k & mask
    pv = unmonotone_f32(p & ~mask)
    live = ~kn & (kv > 0.5 * NEG_INF)
    if not torch.equal(live, ~pn & (pv > 0.5 * NEG_INF)):
        raise AssertionError(f"probe {variant}: other bins empty than in the plain version")
    rtol = RTOL_EXACT_PRODUCTS
    q = qs.double()
    blocks = codes3[torch.unique(u_all).long()].float()
    atol = rtol * float((q * q).sum(-1).max() + (blocks * blocks).sum(-1).max())
    rel = rtol + 2.0 ** (nbits - 22)
    diff = (kv - pv).abs()[live]
    err = float(diff.max()) if live.any() else 0.0
    if not bool((diff <= atol + rel * pv.abs()[live]).all()):
        raise AssertionError(f"probe {variant}: values differ by {err}")
    rsq = aux3[:, 0].contiguous().view(torch.float32).double()
    slot = torch.arange(k.shape[-1], device=k.device) % window
    for c in range(u_all.shape[0]):
        x = codes3[u_all[c].long()].double()                         # (U, window, D)
        s = 2.0 * torch.einsum("qd,usd->qus", q[c], x) - rsq[u_all[c].long()][None]
        s = torch.where(aux3[u_all[c].long(), 1][None] >= 0, s, NEG_INF)
        own = s[torch.arange(q.shape[1], device=k.device)[:, None], kb[c].long(), slot[None]]
        bad = ((kv[c].double() - own).abs() > atol + rel * own.abs()) & live[c]
        if bool(bad.any()):
            raise AssertionError(f"probe {variant}: values do not carry their blocks' scores")
    if variant == "none" and not bool((kb == u - 1).all()):
        raise AssertionError("probe none must hold the last block's tile")
    return k, err, int((k != p).sum())


def kernel_probe_phase(torch):
    """``benchmarks.kernel_probe.run`` at the script's shape (every variant
    timed on the same synthetic blocks), then each variant against its
    plain version (``probe_check``), ``chain`` against ``temps`` bit for
    bit, and a crafted negative-subnormal score that ``temps_f32`` meets as
    a NaN."""
    from rag_faiss_embedding_tpu_torch.benchmarks import kernel_probe as BK
    from rag_faiss_embedding_tpu_torch.ops import kernel_probe as KP

    inputs = BK.make_inputs(device=torch.device("cuda"), seed=SEED)
    KP.probe.launches = 0  # count the path's launches only
    KP.probe.variant_launches = dict.fromkeys(KP.VARIANTS, 0)
    rows = BK.run(inputs)
    torch.cuda.synchronize()
    launches = dict(KP.probe.variant_launches)
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe variant was never launched: {launches}")

    kw = dict(bb=BK.BB, cap=BK.CAP)
    outs, plain_ms, max_err, mismatch = {}, {}, 0.0, {}
    for variant in KP.VARIANTS:
        outs[variant], err, mismatch[variant] = probe_check(torch, KP, variant, inputs, kw)
        max_err = max(max_err, err)
        plain_ms[variant] = cuda_ms(
            torch, lambda: KP.probe_reference(variant, **inputs, **kw), 3, 1)
    if not torch.equal(outs["chain"], outs["temps"]):
        raise AssertionError("probe chain and temps differ")

    # a zero query row against a norm of 1e-39: the score -1e-39 is a
    # negative subnormal, its packed int a NaN as a float
    crafted = dict(inputs, qs=inputs["qs"].clone(), aux3=inputs["aux3"].clone())
    crafted["qs"][0, 0] = 0
    blk = int(inputs["u_all"][0, 2])
    crafted["aux3"][blk, 0, 7] = torch.tensor(1e-39, dtype=torch.float32,
                                              device="cuda").view(torch.int32)
    for variant in KP.VARIANTS:
        out, err, _ = probe_check(torch, KP, variant, crafted, kw)
        max_err = max(max_err, err)
        if variant == "temps_f32":
            nan_bins = out[0, 0, [7, 7 + BK.WINDOW]]
            if not bool(torch.isnan(nan_bins.view(torch.float32)).all()):
                raise AssertionError("temps_f32 lost the subnormal score's NaN")
    del crafted

    work = scan_work(torch, inputs["qs"], inputs["u_all"], inputs["aux3"][:, 1],
                     BK.CHUNKS * BK.QC, outs["chain"].numel() * 4)
    init_share = float((outs["temps_f32"] == outs["chain"]).float().mean())
    blocks = inputs["codes3"][torch.unique(inputs["u_all"]).long()].double()
    atol = RTOL_EXACT_PRODUCTS * float((inputs["qs"].double() ** 2).sum(-1).max()
                                       + (blocks * blocks).sum(-1).max())
    del blocks
    return {
        "phase": "kernel_probe", "nlist": BK.NLIST, "window": BK.WINDOW, "D": BK.DIM,
        "qc": BK.QC, "U": BK.U, "bb": BK.BB, "cap": BK.CAP, "chunks": BK.CHUNKS,
        "reps": BK.REPS, "path_launches": launches, **work, **work_bound(work),
        "tensor_cores": KP.uses_tensor_cores(torch.cuda.current_device(), BK.DIM, BK.CAP),
        "max_abs_err": max_err, "rtol": RTOL_EXACT_PRODUCTS, "atol": atol,
        "bins_differing_from_plain": mismatch,
        "temps_f32_bins_equal_to_chain": init_share,
        "variants": {r["variant"]: {"ms": r["ms_per_batch"], "plain_ms": plain_ms[r["variant"]]}
                     for r in rows},
    }


def work_bound(work: dict) -> dict:
    """``bound`` of a ``scan_work`` / ``flat_work`` dict, as its keys."""
    return dict(zip(("bound_ms", "bound_by"),
                    bound(work["bytes"], work["flops"], work["dtype"])))


def achieved(work: dict, ms: float) -> dict:
    """``work_bound`` of a kernel call that took ``ms``, with its achieved
    rate (TFLOP/s of the operations ``work`` counts) and its share of the
    bound (bound_ms / ms)."""
    b = work_bound(work)
    return {**b, "tflops": work["flops"] / ms / 1e9, "bound_share": b["bound_ms"] / ms}


def bounds_phase(kernel_cases, ivf, pq) -> dict:
    """Bounds at the 1M shapes of PERF.md's kernel table, beside the times
    the earlier phases took there: K1 over 1,048,576 x 384 float32 at Q = 1
    and 1,024, K2 / K3 at the IVF phase's Q = 1,024 default dispatch, and K4
    decoding 1,048,576 rows of M 48 codes into bf16 (with its one-call
    library equivalent, ``F.embedding`` over the flattened codebook)."""
    out = {}
    for row in kernel_cases:
        case = dict(zip(CASE_COLUMNS, row))
        if case["case"] == "1M x 384":
            work = flat_work(case["Q"], case["N"], case["D"], case["k"])
            out[f"flat_scan Q={case['Q']}"] = dict(achieved(work, case["ms"]), ms=case["ms"],
                                                   plain_ms=case["plain_ms"])
    for c in ivf["kernel_cases"]:
        if c["Q"] == IVF_Q and c["nprobe"] == ivf["resolved_dispatch_q1024"]["nprobe"]:
            out[f"union_scan v{c['variant']} Q={IVF_Q}"] = dict(
                achieved(c, c["ms"]), ms=c["ms"], plain_ms=c["plain_ms"])
    lib = pq["decode_1M_M48_bf16"]
    out["pq_decode 1M M=48 bf16"] = dict(
        achieved({"bytes": lib["bytes"], "flops": 0, "dtype": "bfloat16"}, lib["ms"]),
        ms=lib["ms"], plain_ms=lib["plain_ms"], library_ms=lib["library_ms"])
    return {"phase": "bounds", "hbm_bytes_per_s": HBM_BYTES_PER_S, "peak_flops": PEAK_FLOPS,
            "kernels": out}


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
    from rag_faiss_embedding_tpu_torch.ops import fused_proto as FP
    from rag_faiss_embedding_tpu_torch.ops import kernel_probe as KP
    from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD
    from rag_faiss_embedding_tpu_torch.ops import union_scan as U

    t0 = time.perf_counter()
    names = ("flat_scan", "union_scan", "pq_decode", "fused_proto", "kernel_probe")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:  # one nvcc each
        libs = dict(zip(names, pool.map(_build.build, names)))
    for mod in (F, U, PD, FP, KP):  # load the libraries and bind their entry points
        mod.load()
    emit({"phase": "build", "sources": [KERNEL_SOURCE, UNION_SOURCE, PQ_SOURCE, FP_SOURCE,
                                        KP_SOURCE],
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "nvcc_s": dict(_build.build.seconds),
          "build_and_load_s": time.perf_counter() - t0})

    cases, max_err, paths = kernel_phase(torch, F)
    emit({"phase": "kernel", "kernel": "flat_scan", "rtol": RTOL,
          "atol": "rtol x (max ||q||^2 + max ||x||^2)", "columns": CASE_COLUMNS,
          "cases": cases, "paths_1M_x_384_ms": paths, "tiled_min_q": F.TILED_MIN_Q})

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
        trace, sl = slice_phase(torch, F, Path(workdir))
    emit(sl)
    emit(trace)
    built = ivf_build(torch)
    fp = fused_proto_phase(torch, built[0], built[2], built[3])  # on the untouched index
    emit(fp)
    ivf, union_err = ivf_kernel_phase(torch, *built)
    emit(ivf)
    del built
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
        ivf_trace, ivf_sl = ivf_slice_phase(torch, Path(workdir))
    emit(ivf_sl)
    emit(ivf_trace)
    pq, pq_err = pq_kernel_phase(torch)
    emit(pq)
    pq_traces, pq_sl = pq_slice_phase(torch)
    emit(pq_sl)
    for trace in pq_traces:
        emit(trace)
    kp = kernel_probe_phase(torch)
    emit(kp)
    emit(bounds_phase(cases, ivf, pq))

    loaded = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES]
    if loaded:
        raise AssertionError(f"the port pulled in JAX modules: {loaded}")
    flat_q1 = sl["main_path_kernel_times"]["Q=1"]
    v1 = ivf_sl["main_path_kernel_times"]["Q=1"]
    v2 = ivf["kernel_cases"][1]
    pq_q1 = pq_sl["pq"]["main_path_kernel_times"]["Q=1"]
    chain = kp["variants"]["chain"]
    kernels = [{
        "name": "flat_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sl["flat_scan_launches"],
        "max_abs_err": max(max_err, *(v["max_abs_err"]
                                      for v in sl["main_path_kernel_times"].values())),
        "ms": flat_q1["ms"], "plain_ms": flat_q1["plain_ms"],
        **achieved(flat_work(1, flat_q1["N"], flat_q1["D"], flat_q1["k"]), flat_q1["ms"]),
        "library_ms": None,
    }, {
        "name": "union_scan v1", "route": "cuda", "source": UNION_SOURCE,
        "replaces": UNION_REPLACES[1], "launches": ivf_sl["union_scan_v1_launches"],
        "max_abs_err": max(union_err[1], ivf_sl["max_abs_err"]),
        "ms": v1["ms"], "plain_ms": v1["plain_ms"],
        **achieved(v1, v1["ms"]),
        "library_ms": None,
    }, {
        "name": "union_scan v2", "route": "cuda", "source": UNION_SOURCE,
        "replaces": UNION_REPLACES[2], "launches": ivf["path_launches"][2],
        "max_abs_err": union_err[2], "ms": v2["ms"], "plain_ms": v2["plain_ms"],
        **achieved(v2, v2["ms"]),
        "library_ms": None,
    }, {
        "name": "pq_decode", "route": "cuda", "source": PQ_SOURCE,
        "replaces": PQ_REPLACES, "launches": pq_sl["pq_decode_launches"],
        "max_abs_err": max(pq_err, *(pq_sl[k]["max_abs_err"] for k in ("pq", "ivf_pq"))),
        "ms": pq_q1["ms"], "plain_ms": pq_q1["plain_ms"],
        **achieved({"bytes": pq_q1["bytes"], "flops": 0, "dtype": pq_q1["dtype"]}, pq_q1["ms"]),
        "library_ms": pq_q1["library_ms"],
    }, {
        "name": "fused_proto", "route": "cuda", "source": FP_SOURCE,
        "replaces": FP_REPLACES, "launches": fp["path_launches"],
        "max_abs_err": fp["max_abs_err"], "ms": fp["ms"], "plain_ms": fp["plain_ms"],
        **achieved(fp, fp["ms"]), "library_ms": None,
    }, {
        "name": "kernel_probe", "route": "cuda", "source": KP_SOURCE,
        "replaces": KP_REPLACES, "launches": sum(kp["path_launches"].values()),
        "max_abs_err": kp["max_abs_err"], "ms": chain["ms"], "plain_ms": chain["plain_ms"],
        **achieved(kp, chain["ms"]), "library_ms": None,
        "variants": {v: {**t, "launches": kp["path_launches"][v]}
                     for v, t in kp["variants"].items()},
    }]
    if any(e["launches"] <= 0 for e in kernels):
        raise AssertionError("a kernel was not launched on its path")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
