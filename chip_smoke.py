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
   The encoder's bf16 compute mode, at full width with the same weights,
   embeds the slice's queries, held to the float32 CPU pipeline by cosine
   (> 0.99).
   Then one request for 100 hits, above the tiled path's KMAX: the kernel
   serves it (one launch) and it is held to the CPU index. The kernel phase
   holds K1 to its plain version at k up to 5,000 and with dead rows too.
5. trace: the same engine, warm: request latency on the host clock, its
   stages (tokenize, embed, scan, SQLite), a ``torch.profiler`` trace of 8
   requests (device busy time per request, by kernel, and the device's idle
   share), and the encoder's device time at 1, 16 and 32 rows (bf16 beside
   float32 under ``encoder_bf16``).
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
   1,048,576: the rows its paths launch it on (``PQ_PATH_ROWS``, at M 48),
   both sides of each end of the band of N where the plan stages the
   codebook (``pq_decode.staged_rows``) and whole tiles +-1 row;
   CUDA-event times of both. Then phase 6's 1M rows in
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

13. int8 (after phase 6, on its coarse quantizer): phase 6's 1M rows and
    queries made again from the seed; the exact float32 top-10 from a float
    ``FlatIndex(selector="approx")`` search, which must launch K1 once; int8
    ``FlatIndex``es with the "exact", "approx" and "rerank" selectors: add
    time, bytes per row, recall@10 at Q 1 and 1,024 ("rerank" >= 0.99 at Q
    1,024, the JAX package's gate), CUDA-event search times, each held to the
    same index moved to the CPU; ``torch._int_mm`` against the plain product
    of the codes at the path's shapes (a query block x 524,288 rows), bit for
    bit, both timed; a profile of the rerank index's searches; then
    ``IVFFlatIndex(384, nlist=8192, dtype="int8", train_iters=10,
    balance="reassign")`` with its bf16 shadow: build time, recall@10 (>=
    RECALL_MIN) and search times at Q 1 and 1,024, held to the CPU.
14. int8_slice: ``RAGManager(Config(index_dtype="int8"))``, flat and IVF
    (nlist 64), over the slice's documents and requests: saved, reloaded
    (the flat one still "rerank", the IVF one with its shadow), each
    request's results held to the saved index searched on the CPU, and
    ``torch._int_mm`` run on every search.
15. serve: the port's HTTP server (``serve.api.make_app``) in this process on
    ``127.0.0.1:0`` over a flat ``RAGManager`` of the slice's 4,096
    documents at full MiniLM-L6 width (``serve_max_batch`` 64, the default 2
    ms window, no periodic watchdog): one watchdog probe; ``/health``; 256
    ``POST /search`` requests (top_k 1-10 from the seed) from 64 client
    threads, whose batches (``/stats``) must each have launched K1 once and
    each equal the same engine's ``search_batch`` of the same texts on the
    saved index loaded on the CPU, every answer its batch's list cut to its
    top_k; 32 sequential requests; a filtered request (K1 with its mask) and
    one that generates an answer; two documents added, found, deleted and
    gone; 400 / 422 / 404 / 405. Then the same server over an IVF manager
    (nlist 64): 64 concurrent requests, K2 launched, held to the CPU the same
    way. Then ``cli.pipeline`` over ``examples/corpus`` (5 pages indexed)
    and ``cli.selfindex`` over the port's package (one document per ``.py``
    file) at once, then ``cli.search`` for one page's text (its title
    first), each a subprocess on the card. HTTP latency p50 / p99 on the host
    clock, the batch sizes and the launches.

16. chunked (after phase 13, on phase 6's coarse quantizer): the JAX
    record's 10M shape, ``IVFFlatIndex(384, nlist=16384, nprobe=16,
    pq_m=48, train_iters=10, rerank=True, refine_dtype="bfloat16",
    rerank_depth=128, balance="spill")`` built by ``build_chunked`` over
    10,485,760 rows of bench.py's distribution in chunks of 524,288, the
    rows made on the card as a pure function of (start, size): the build's
    stages, window, spill rows, the device's peak memory by stage against
    the resident bytes and a working-set bound set by the chunk and the
    score tile (not by n), host memory; the exact float32 top-10 of 1,024
    queries streamed through the flat-scan kernel; searches at nprobe 8, 16
    and 32, Q 1 and 1,024 (recall@10 and @1 as information, CUDA-event
    ms), the decode kernel bit for bit against the plain decode. Then three
    chunked builds at 1M on phase 6's rows: IVF-PQ ``balance="spill"``
    pinned to a dense build's training (the same slots, codes differing only
    at near-tie codewords), ``balance="reassign"`` at cap_factor 1.3 (every
    row placed or pending, window within the cap, spilled rows find
    themselves), and bf16 storage through the union-scan kernel (recall@10
    >= RECALL_MIN, kernel vs plain as phase 6 holds them).
17. train: full-width MiniLM-L6 with a vocabulary trained on the slice's
    documents (8,192): one step from the same parameters and first batch
    (32 x 128) on the card and the CPU (loss within 1e-4 relative, each
    gradient within 1e-4 of its tensor's largest entry (at least 1e-2 of the
    model's largest), every weight within
    lr / 100 but where the gradient is below 1e-6 (the attention key
    biases, whose exact gradient is zero, among them): there within 1.01 x
    lr of its start); the same first step and two more on a {"data": 2,
    "model": 2} mesh over four repeated positions of the card (data and
    tensor parallel), held the same way to the one-card step on the card,
    the losses of all three within 1e-4 relative, CUDA-event ms per step of
    both in turns; a checkpoint saved from the mesh restored on one card bit
    for bit, its next step held to the mesh's; ``cli.train.train`` over the
    four positions logging JAX's mesh; ``cli.train.train``
    at the CLI's defaults (200 steps, batch 32, max_len 128, lr 2e-5) with a
    checkpoint and exported params: ms per step, sequences and tokens per
    second, peak device memory, the loss falling; two more steps from the
    restored checkpoint equal to two from memory, bit for bit (both under
    torch's deterministic algorithms: the default kernels are not
    bit-reproducible from run to run); then
    ``cli.train`` as a subprocess (20 steps) and a ``RAGManager`` on what it
    wrote, indexing the slice's documents and serving its requests through
    the flat-scan kernel.
18. sharded (after phase 16): a mesh of every card on a "db" axis, or of
    4 shards on the one card (printed on its own line with the device
    count). ``ShardedFlatIndex`` over BASELINE.md config #4, 10,485,760 x
    384 float32 rows of bench.py's distribution made on the card and added
    chunk by chunk (capacity set up front): k 10 at Q 1 and 1,024, then with
    30% of the rows removed and under a filter, each held to the streamed
    ground truth, one K1 launch per shard per search, CUDA-event ms, K1
    against its plain version on a shard. ``ShardedIVFIndex(nlist 8,192)``
    over phase 6's rows on phase 6's centroids: bf16 (K2 per shard), int8
    and IVF-PQ M 48 (K4 per shard); recall@10 at nprobe 8 and 16, Q 1 and
    1,024 (bf16 and int8 >= RECALL_MIN and within RECALL_SLACK of a one-card
    ``IVFFlatIndex`` on the same centroids); the kernel routes against the
    plain ones (K4 bit for bit); K2 against its plain version on two shards;
    a profile of the bf16 searches. The bf16 index saved through
    ``VectorStore`` and reloaded onto the same mesh (bit-exact, no build)
    and with no mesh (every visible card, re-striped). The slice's 4,096
    documents served by ``QueryEngine`` from a ``sharded_ivf`` file of
    their embeddings (K2 on every shard; probing every list, the one-card
    IVF engine's answers).

Then a ``{"kernels": [...]}`` line (launch counts from each kernel's path,
with a ``paths`` breakdown: the flat scan's from the slice, the server, the
10M ground truth, the trained manager and the sharded 10M searches,
union-scan variant 1's from the IVF slice, the IVF server, the chunked bf16
build and the sharded IVF (1M and the slice), variant 2's from the IVF
kernel phase, the PQ decode's from the PQ slice, the 10M searches and the
sharded IVF-PQ (with the rows of its launches on each path, and its times
at a shard's union: per call and device time),
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
import hashlib
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
# exact products) for bf16 storage, int8 tensor cores (int32 accumulation)
# for the int8 tier's product.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# top-level packages the port must never load
FORBIDDEN_MODULES = ("jax", "flax", "optax", "orbax", "rag_faiss_embedding_tpu")
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


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of ``fn`` in ms: the summed time of the kernels it
    launches, over ``reps`` warm calls, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back with device events missing
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(on_card) >= reps:  # fn launches at least one kernel a call
            return sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / reps
    raise AssertionError("torch.profiler missed the device's kernels three times")


def host_us(torch, fn, reps: int) -> float:
    """Host-clock time of one call of ``fn`` in microseconds: ``reps``
    back-to-back calls with no synchronize in between (fewer than the
    launch queue holds, so the host does not wait for the device)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def rows_histogram(rows) -> dict:
    """K4's rows per launch on one path: count, min, median, max, and the
    launches in each power-of-two bucket (key: the bucket's upper bound)."""
    hist = {}
    for n in rows:
        b = 1 << max(0, int(n) - 1).bit_length()
        hist[b] = hist.get(b, 0) + 1
    return {"launches": len(rows), "min": min(rows, default=None),
            "median": statistics.median(rows) if rows else None,
            "max": max(rows, default=None),
            "buckets": {str(b): hist[b] for b in sorted(hist)}}


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
    trace["encoder_bf16"] = bf16_encoder_check(torch, manager.embedder, cpu_pipe,
                                               queries + batch_queries)
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
PQ_DECODE_COLUMNS = ["D", "M", "ksub", "dtype", "N", "staged", "groups", "max_abs_err", "ms",
                     "plain_ms"]
# K4's rows per launch on its paths (the kernels line's rows_per_launch):
# the PQ slice's 4,096 and 16,384, a shard's union of the sharded IVF-PQ
# (16,384 and 32,768), union segments of the 10M chunked IVF-PQ (180,224
# and 360,448), flat PQ's 524,288-row chunks
PQ_PATH_ROWS = (4096, 16384, 32768, 180224, 360448, 1 << 19)


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
    256, bf16 and f32 codebooks, N from 0 to 1,048,576 (``PQ_PATH_ROWS`` at
    M 48, ksub 256; the rows on both sides of each end of the staged band;
    whole tiles +-1 row near 4,096 and 16,384 rows); at 1,048,576 rows of M
    48 ksub 256 bf16 also its one-call library equivalent."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    card = dict(zip(("sms", "smem_limit"), PD._card(torch.cuda.current_device())))
    cases, max_err, at_1m = [], 0.0, None
    for d, m in ((384, 16), (384, 48), (384, 96), (768, 96)):
        for ksub in (16, 256):
            for dtype in (torch.bfloat16, torch.float32):
                cb = torch.randn((m, ksub, d // m), generator=g, device="cuda").to(dtype)
                rows = {0, 1, 127, 4096, 1 << 20}
                if (d, m, ksub) == (384, 48, 256):
                    rows.update(PQ_PATH_ROWS)
                band = PD.staged_rows(m, ksub, d // m, dtype, **card)
                if band is not None:
                    rows.update((band.start - 1, band.start, band.stop - 1, band.stop))
                for n0 in (4096, 16384):  # one past and one short of whole tiles
                    tile = PD.plan(m, ksub, d // m, dtype, n0, **card)["tile_rows"]
                    rows.update((n0 // tile * tile - 1, n0 // tile * tile + 1))
                for n in sorted(rows):
                    codes = torch.randint(0, ksub, (n, m), generator=g,
                                          device="cuda").to(torch.uint8)
                    err, ms, plain_ms = decode_check(torch, PD, cb, codes)
                    max_err = max(max_err, err)
                    p = PD.plan(m, ksub, d // m, dtype, n, **card)
                    cases.append([d, m, ksub, str(dtype).removeprefix("torch."), n,
                                  p["staged"], p["groups"], err, ms, plain_ms])
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

    PD.decode.launches, PD.decode.rows = 0, []  # count the main path's launches only
    run = drive_slice(torch, cfg, docs, queries, batch_queries)
    launches, launch_rows = PD.decode.launches, PD.decode.rows[:PD.decode.launches]
    PD.decode.rows = None

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
           "pq_decode_rows": launch_rows,
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
    out["pq_decode_rows_per_launch"] = rows_histogram(
        out["pq"].pop("pq_decode_rows") + out["ivf_pq"].pop("pq_decode_rows"))
    return traces, out


# ----------------------------------------------------------------- phase 13
INT8_SELECTORS = ("exact", "approx", "rerank")
INT8_CPU_Q = 8  # queries of the 1M int8 indexes held to the same index on the CPU


def int8_same_topk(torch, q, x_sq_max: float, kv, ki, pv, pi, rtol):
    """An int8 index's result (kv, ki) against the same index on the CPU
    (pv, pi): the same slots filled, values within rtol x (max ||q||^2 +
    max ||x||^2) (the int32 dots are exact on both; norms and the rerank's
    re-score are summed in other orders), ids equal except where the CPU's
    value ties another in its list (or sits in the last slot). Returns
    (max_abs_err, id mismatches)."""
    kv, ki = kv.cpu(), ki.cpu()
    qf = q.cpu().double()
    atol = rtol * (float((qf * qf).sum(1).max()) + x_sq_max)
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)) or not torch.equal(ki < 0, pi < 0):
        raise AssertionError("the card and the CPU fill different slots")
    diff = (kv - pv).abs()[fin]
    err = float(diff.max()) if fin.any() else 0.0
    if not bool((diff <= atol + rtol * pv.abs()[fin]).all()):
        raise AssertionError(f"the card's int8 values differ from the CPU's by {err}")
    for r, c in (ki != pi).nonzero().tolist():
        tied = int(((pv[r] - pv[r, c]).abs() <= atol + rtol * abs(float(pv[r, c]))).sum()) > 1
        if not tied and c != ki.shape[1] - 1:
            raise AssertionError(f"int8 ids differ away from a tie (query {r}, slot {c})")
    return err, int((ki != pi).sum())


def int8_bytes_per_row(idx) -> int:
    """Device bytes a row of an int8 flat index holds: code, scale, exact
    norm, and the bf16 shadow row where there is one."""
    per = idx._buf.element_size() * idx.dim + idx._scales.element_size() + idx._sq.element_size()
    return per + (idx._shadow.element_size() * idx.dim if idx._shadow is not None else 0)


def int_mm_case(torch, Q, q_i8, rows) -> dict:
    """``int8_dots`` (``torch._int_mm``) against the plain product of the
    codes on the same card tensors: equal bit for bit, both timed, with the
    product's bound (rows, queries read once, int32 out; int8 operations at
    the tensor-core peak)."""
    got = Q.int8_dots(q_i8, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, Q.int8_dots_reference(q_i8, rows)):
        raise AssertionError("torch._int_mm differs from the plain product of the codes")
    nq, d = q_i8.shape
    n = rows.shape[0]
    bound_ms, bound_by = bound(n * d + nq * d + nq * n * 4, 2 * nq * n * d, "int8")
    return {"Q": nq, "N": n, "D": d, "bit_equal": True,
            "ms": cuda_ms(torch, lambda: Q.int8_dots(q_i8, rows)),
            "plain_ms": cuda_ms(torch, lambda: Q.int8_dots_reference(q_i8, rows), reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by}


def int8_flat_run(torch, Q, db, queries, truth, x_sq_max: float):
    """The three selectors over bench.py's 1M rows in int8 ``FlatIndex``es:
    add time, bytes per row, recall@10 at Q 1 (64 single queries) and Q
    1,024 against the exact float32 top-10, CUDA-event search times; each
    index held to the same index moved to the CPU at Q = INT8_CPU_Q. Returns
    (entries, the rerank index, the int8 product's launches in the recall
    searches)."""
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at
    from rag_faiss_embedding_tpu_torch.index import FlatIndex

    cuda = torch.device("cuda")
    single, qh = queries[:64], queries[:INT8_CPU_Q]
    entries, kept, launches = [], None, 0
    for sel in INT8_SELECTORS:
        t0 = time.perf_counter()
        idx = FlatIndex(IVF_DIM, dtype="int8", selector=sel, capacity=IVF_N, device=cuda)
        idx.add(db)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        before = Q.int8_dots.launches
        ids1 = torch.cat([idx.search(single[i:i + 1], 10)[1] for i in range(len(single))])
        _, ids = idx.search(queries, 10)
        torch.cuda.synchronize()
        launches += Q.int8_dots.launches - before
        cpu = FlatIndex.from_state_dict(idx.state_dict(), selector=sel, device="cpu")
        kv, ki = idx.search(qh, 10)
        err, mism = int8_same_topk(torch, qh, x_sq_max, kv, ki, *cpu.search(qh.cpu(), 10),
                                   RTOL["float32"])
        entries.append({
            "selector": sel, "add_s": add_s, "bytes_per_row": int8_bytes_per_row(idx),
            "recall@10_q1": recall_at(ids1, truth[:len(single)]),
            "recall@10_q1024": recall_at(ids, truth),
            "search_ms_q1": cuda_ms(torch, lambda: idx.search(single[:1], 10)),
            "search_ms_q1024": cuda_ms(torch, lambda: idx.search(queries, 10), reps=3, warm=1),
            "max_abs_err_vs_cpu": err, "id_mismatch_vs_cpu": mism})
        del cpu
        if sel == "rerank":
            kept = idx
        else:
            del idx
            torch.cuda.empty_cache()
    return entries, kept, launches


def int8_ivf_run(torch, db, queries, truth, coarse):
    """bench.py's 1M rows in ``IVFFlatIndex(384, nlist=8192, dtype="int8",
    train_iters=10, balance="reassign")`` with its bf16 shadow, on the bf16
    build's coarse quantizer: build time and stats, recall@10 and host-clock
    search times at Q 1 and 1,024 at the default nprobe and 16, and the
    index held to the same state on the CPU."""
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex

    cuda = torch.device("cuda")
    single = queries[:64]
    t0 = time.perf_counter()
    idx = IVFFlatIndex(IVF_DIM, nlist=IVF_NLIST, dtype="int8", train_iters=10,
                       balance="reassign", device=cuda)
    idx.centroids, idx.is_trained = coarse.centroids, True
    idx.build(db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if idx._sorted_shadow is None or idx.resolved_dispatch(IVF_Q)["backend"] != "xla":
        raise AssertionError("the int8 IVF index must rerank on the plain chunk body")
    routes = []
    for nprobe in (None, 16):
        ids1 = torch.cat([idx.search(single[i:i + 1], 10, nprobe=nprobe)[1]
                          for i in range(len(single))])
        _, ids = idx.search(queries, 10, nprobe=nprobe)
        r = {"nprobe": nprobe or idx.nprobe,
             "recall@10_q1": recall_at(ids1, truth[:len(single)]),
             "recall@10_q1024": recall_at(ids, truth),
             "search_ms_q1": host_ms(torch, lambda: idx.search(single[:1], 10, nprobe=nprobe), 10),
             "search_ms_q1024": host_ms(torch, lambda: idx.search(queries, 10, nprobe=nprobe), 3)}
        if min(r["recall@10_q1"], r["recall@10_q1024"]) < RECALL_MIN:
            raise AssertionError(f"int8 IVF recall@10 below {RECALL_MIN}: {r}")
        routes.append(r)
    qh = queries[:INT8_CPU_Q]
    cpu = IVFFlatIndex.from_state_dict(idx.state_dict(), device="cpu")
    kv, ki = idx.search(qh, 10)
    pv, pi = cpu.search(qh.cpu(), 10)
    err, mism = int8_same_topk(torch, qh, float(idx._sorted_sq.max()), kv, ki, pv, pi,
                               RTOL["float32"])
    del cpu
    out = {"nlist": idx.nlist, "build_s": build_s,
           "build_stats": {k: v for k, v in idx.build_stats.items() if k != "train"},
           "window": idx._window, "spill_rows": idx._n_spill,
           "resolved_dispatch_q1024": idx.resolved_dispatch(IVF_Q), "routes": routes,
           "max_abs_err_vs_cpu": err, "id_mismatch_vs_cpu": mism,
           "search_profile_q1024": search_profile(torch, idx, queries, 2)}
    del idx
    torch.cuda.empty_cache()
    return out


def int8_phase(torch, F, coarse):
    """The int8 tier at bench.py's IVF shape (phase 6's rows and queries,
    made again from the seed): the exact float32 top-10 from a float
    "approx" search (which must launch K1), the int8 flat selectors, the
    int8 product against its plain version at the path's shapes, a profile
    of the rerank index's searches, and the int8 IVF index."""
    from rag_faiss_embedding_tpu_torch.index import FlatIndex
    from rag_faiss_embedding_tpu_torch.ops import quantize as Q

    cuda = torch.device("cuda")
    db, queries = bench_rows(torch)
    flat = FlatIndex(IVF_DIM, selector="approx", capacity=IVF_N, device=cuda)
    flat.add(db)
    before = F.flat_search.launches
    _, truth = flat.search(queries, 10)
    torch.cuda.synchronize()
    k1_launches = F.flat_search.launches - before
    if k1_launches != 1:
        raise AssertionError(f"a float 'approx' search launched K1 {k1_launches} times")
    x_sq_max = float(flat._sq[:IVF_N].max())
    del flat
    torch.cuda.empty_cache()

    flats, rerank_idx, launches = int8_flat_run(torch, Q, db, queries, truth, x_sq_max)
    if launches == 0:
        raise AssertionError("the int8 flat searches never ran torch._int_mm")
    rerank = next(e for e in flats if e["selector"] == "rerank")
    if rerank["recall@10_q1024"] < 0.99:
        raise AssertionError(f"int8 rerank recall@10 {rerank['recall@10_q1024']} < 0.99")
    # the product at the path's shapes: a query block against one chunk of rows
    chunk = rerank_idx._buf[:min(524288, rerank_idx._capacity)]
    mm_cases = []
    for nq in (1, IVF_Q):
        a, b = Q._query_blocks(nq, chunk.shape[0])[0]
        q_i8, _ = Q.quantize_rows(queries[a:b])
        mm_cases.append(int_mm_case(torch, Q, q_i8, chunk))
    profiles = {f"Q={q.shape[0]}": search_profile(torch, rerank_idx, q, reps)
                for q, reps in ((queries[:1], 8), (queries, 2))}
    del rerank_idx, chunk
    torch.cuda.empty_cache()
    ivf = int8_ivf_run(torch, db, queries, truth, coarse)
    return {"phase": "int8", "N": IVF_N, "D": IVF_DIM, "k": 10,
            "k1_launches_approx_f32": k1_launches, "int8_dots_launches": launches,
            "flat": flats, "int_mm_cases": mm_cases, "flat_rerank_profile": profiles,
            "ivf": ivf}


def int8_slice_phase(torch):
    """``RAGManager(Config(index_dtype="int8"))``, flat and IVF (nlist 64),
    over the slice's documents and requests, each in a fresh directory:
    ingest, requests, save, reload (the flat one as "rerank", the IVF one
    with its shadow), and the results held to the saved index searched on
    the CPU. The int8 product must run on each path."""
    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex, VectorStore
    from rag_faiss_embedding_tpu_torch.ops import quantize as Q

    docs = corpus_documents(N_DOCS, SEED)
    picks, queries, batch_queries = slice_requests(docs)
    out = {"phase": "int8_slice"}
    for kind, cls in (("flat", FlatIndex), ("ivf", IVFFlatIndex)):
        with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
            cfg = Config(base_dir=Path(workdir), model_name="chip-smoke-random-init",
                         index_kind=kind, ivf_nlist=64, index_dtype="int8")
            Q.int8_dots.launches = 0  # count the main path's products only
            run = drive_slice(torch, cfg, docs, queries, batch_queries)
            launches = Q.int8_dots.launches
            index, again = run.manager.vector_store.index, run.reloaded.vector_store.index
            if not (isinstance(index, cls) and isinstance(again, cls) and index.quantized
                    and again.quantized):
                raise AssertionError(f"the int8 {kind} manager did not build its index")
            reranks = ((index.selector, again.selector) == ("rerank", "rerank") if kind == "flat"
                       else index._sorted_shadow is not None and again._sorted_shadow is not None)
            if not reranks:
                raise AssertionError(f"the int8 {kind} index lost its rerank on reload")
            self_hits = check_slice(run, docs, picks, 0)
            if launches < run.searches:
                raise AssertionError(f"torch._int_mm ran {launches} times for "
                                     f"{run.searches} searches")
            cpu = VectorStore(index.dim, index_path=cfg.index_path, device="cpu").index
            if kind == "flat" and cpu.selector != "rerank":
                raise AssertionError("the saved int8 flat index loads on the CPU without "
                                     "its rerank")
            x_sq = float((index._sq if kind == "flat" else index._sorted_sq).max())
            held = []
            for texts in (queries, batch_queries):
                emb = run.manager.embedder.generate_embeddings(texts)
                held.append(int8_same_topk(torch, torch.from_numpy(emb), x_sq,
                                           *index.search(emb, 5), *cpu.search(emb, 5),
                                           RTOL["float32"]))
            run.manager.cleanup()
            run.reloaded.cleanup()
        out[kind] = {**slice_summary(run, f"int8_{kind}", self_hits, held[0][1], held[1][1]),
                     "int8_dots_launches": launches, "selector": cfg.search_selector,
                     "max_abs_err_vs_cpu": max(held[0][0], held[1][0])}
    return out


# ------------------------------------------------------------------ phase 15
SERVE_CLIENTS = 64  # client threads
SERVE_REQUESTS = 256  # concurrent requests to the flat server
SERVE_SEQUENTIAL = 32
IVF_SERVE_REQUESTS = 64


def http_json(port: int, method: str, path: str, body=None, raw=None):
    """(status, JSON body, ms on the host clock) of one request on its own
    connection; every response must carry Content-Length and a JSON
    Content-Type."""
    import http.client

    data = raw if raw is not None else (None if body is None else json.dumps(body))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t = time.perf_counter()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = resp.read()
        ms = (time.perf_counter() - t) * 1e3
    finally:
        conn.close()
    if not (resp.getheader("Content-Type", "").startswith("application/json")
            and int(resp.getheader("Content-Length", "-1")) == len(payload)):
        raise AssertionError(f"{method} {path}: response without its JSON headers")
    return resp.status, json.loads(payload), ms


def percentiles(ms) -> dict:
    s = sorted(ms)
    return {"n": len(s), "p50_ms": s[len(s) // 2],
            "p99_ms": s[min(len(s) - 1, int(len(s) * 0.99))], "max_ms": s[-1]}


def batch_sizes(stats: dict) -> dict:
    """{batch size: batches} from the server's /stats."""
    return {int(re.fullmatch(r"batch_search\(n=(\d+)\)", k).group(1)): v["count"]
            for k, v in stats.items()}


def cpu_copy(torch, manager, engine, backend=None):
    """The same engine (its encoder on the card, its SQLite store) over the
    saved index loaded on the CPU: the kernel's plain version serves it."""
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, VectorStore
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine

    store = VectorStore(manager.vector_store.index.dim,
                        index_path=manager.config.index_path, device="cpu")
    if backend is not None:  # the IVF index through the union scan's plain version
        store.index = IVFFlatIndex.from_state_dict(
            manager.vector_store.index.state_dict(), device="cpu", backend=backend)
    if store.doc_ids != manager.vector_store.doc_ids:
        raise AssertionError("the saved index maps other documents")
    return QueryEngine(manager.db, store, manager.embedder, generator=engine.generator)


def record_batches(engine) -> list:
    """Record every batch the server searches, (texts, k, results, ms on
    the worker thread), as the engine's search_batch runs them; ``del
    engine.search_batch`` stops it."""
    batches, search_batch = [], engine.search_batch

    def recorded(texts, k):
        t = time.perf_counter()
        out = search_batch(texts, k)  # ends with the hits on the host
        batches.append((list(texts), k, out, (time.perf_counter() - t) * 1e3))
        return out

    engine.search_batch = recorded
    return batches


def serve_tolerance(reference, texts) -> float:
    """assert_same_topk's atol for these queries over the reference's rows:
    rtol x (max ||q||^2 + max ||x||^2)."""
    import numpy as np

    rows = reference.vector_store.index.vectors().astype(np.float64)
    q = reference.embedder.generate_embeddings(texts).astype(np.float64)
    return RTOL["float32"] * float((q * q).sum(1).max() + (rows * rows).sum(1).max())


def check_served(answers, requests, batches, reference) -> dict:
    """Each batch the server searched equals the same engine's search_batch
    of the same texts on the CPU copy of the index (same_hits: ids except at
    near-ties, distances to rtol 1e-5 and assert_same_topk's atol; a batch's
    union of IVF lists depends on its queries, so the CPU searches the same
    batches). Each answer is 200, holds its top_k hits, and is its batch's
    list cut to that top_k."""
    served, mismatched, max_err = {}, 0, 0.0
    for texts, k, results, _ in batches:
        atol = serve_tolerance(reference, texts)
        for text, hits, ref in zip(texts, results, reference.search_batch(texts, k)):
            if not same_hits(hits, ref, RTOL["float32"], atol):
                raise AssertionError(
                    f"served hits differ from the CPU copy's: "
                    f"{[(h['id'], h['distance']) for h in hits]} vs "
                    f"{[(h['id'], h['distance']) for h in ref]}")
            mismatched += [h["id"] for h in hits] != [h["id"] for h in ref]
            max_err = max([max_err] + [abs(a["distance"] - b["distance"])
                                       for a, b in zip(hits, ref)])
            served.setdefault(text, []).append(json.loads(json.dumps(hits)))
    for (status, body, _), (text, k) in zip(answers, requests):
        hits = body.get("similar_documents") if status == 200 else None
        if hits is None or len(hits) != k:
            raise AssertionError(f"a request for {k} hits got {status}: {str(body)[:200]}")
        if not any(hits == full[:k] for full in served.get(text, [])):
            raise AssertionError("an answer is not its batch's search")
    return {"requests": len(answers), "batches_held": len(batches),
            "search_batch_ms": [round(b[3], 3) for b in batches][:64],
            "id_lists_differing_at_ties": mismatched, "max_abs_distance_err_vs_cpu": max_err}


def batch_stages(engine, texts, k: int = 10, reps: int = 3) -> dict:
    """Median host-clock ms of a warm search_batch's stages at len(texts)
    queries: tokenize, embed (ends in a device-to-host copy), index search
    (so does this), SQLite fetch, and the whole call."""
    emb, store = engine.embedder, engine.vector_store
    stages = {"tokenize": [], "embed": [], "vector_store.search": [], "sqlite_fetch": [],
              "search_batch": []}
    for _ in range(reps):
        t = time.perf_counter()
        emb.tokenizer.encode_batch(texts, emb.max_seq_length)
        stages["tokenize"].append(time.perf_counter() - t)
        t = time.perf_counter()
        vecs = emb.generate_embeddings(texts)
        stages["embed"].append(time.perf_counter() - t)
        t = time.perf_counter()
        _, ids = store.search(vecs, k)
        stages["vector_store.search"].append(time.perf_counter() - t)
        t = time.perf_counter()
        for row in ids:
            engine.db.get_documents_by_ids(row)
        stages["sqlite_fetch"].append(time.perf_counter() - t)
        t = time.perf_counter()
        engine.search_batch(texts, k)
        stages["search_batch"].append(time.perf_counter() - t)
    return {name: statistics.median(v) * 1e3 for name, v in stages.items()}


async def serve_flat(torch, F, manager, engine, cfg, docs, texts, pool) -> dict:
    """The flat server: probe, health, 256 concurrent requests, 32 sequential
    ones, a filtered and a generating request, writes, error statuses."""
    import asyncio

    import numpy as np

    from rag_faiss_embedding_tpu_torch.serve.api import make_app

    reference = cpu_copy(torch, manager, engine)  # the saved 4,096-row index
    loop = asyncio.get_running_loop()
    app = make_app(engine, cfg, manager=manager)
    port = await app.start("127.0.0.1", 0)

    def call(method, path, body=None, raw=None):
        return loop.run_in_executor(pool, http_json, port, method, path, body, raw)

    try:
        before = F.flat_search.launches
        await app.probe()  # one watchdog self-probe, checked on its own
        probe_launches = F.flat_search.launches - before
        if app.watchdog["status"] != "healthy" or probe_launches != 1:
            raise AssertionError(f"watchdog probe: {app.watchdog}, {probe_launches} launches")
        status, health, _ = await call("GET", "/health")
        if (status, health["status"], health["documents"], health["vectors"]) != (
                200, "healthy", N_DOCS, N_DOCS):
            raise AssertionError(f"/health answered {status} {health}")

        rng = np.random.default_rng(SEED + 15)
        requests = [(t, int(k)) for t, k in zip(texts, rng.integers(1, 11, len(texts)))]
        batches = record_batches(engine)
        F.flat_search.launches = 0  # count the concurrent run's launches only
        t0 = time.perf_counter()
        answers = await asyncio.gather(*[call("POST", "/search", {
            "text": t, "top_k": k, "generate": False}) for t, k in requests])
        concurrent_s = time.perf_counter() - t0
        launches = F.flat_search.launches
        _, stats, _ = await call("GET", "/stats")
        sizes = batch_sizes(stats)
        if not launches == len(batches) == sum(sizes.values()) or max(sizes) < 2:
            raise AssertionError(f"{launches} K1 launches for batches {sizes}")
        concurrent_batches = list(batches)

        seq_requests = [(text, 5) for text, _ in requests[:SERVE_SEQUENTIAL]]
        seq_answers = [await call("POST", "/search", {"text": text, "top_k": k,
                                                      "generate": False})
                       for text, k in seq_requests]
        seq_batches = batches[len(concurrent_batches):]
        seq_launches = F.flat_search.launches - launches
        if not seq_launches == len(seq_batches) == SERVE_SEQUENTIAL:
            raise AssertionError(f"{seq_launches} K1 launches for {len(seq_batches)} "
                                 f"sequential batches")
        del engine.search_batch  # the writes below change the index
        _, stats, _ = await call("GET", "/stats")  # the loop's view of each batch

        where = {"url_prefix": "https://synthetic.example/"}
        before = F.flat_search.launches
        filtered = await call("POST", "/search", {"text": texts[1], "top_k": 5,
                                                  "filter": where, "generate": False})
        filter_launches = F.flat_search.launches - before
        if filter_launches != 1 or not all(h["url"].startswith(where["url_prefix"])
                                           for h in filtered[1]["similar_documents"]):
            raise AssertionError(f"the filtered request took {filter_launches} launches")
        status, answered, _ = await call("POST", "/search", {"text": texts[2], "top_k": 3})
        if status != 200 or not answered.get("generated_response"):
            raise AssertionError("no generated_response")

        # writes: two new documents are found first, then gone once deleted
        words = " ".join(d["content"] for d in docs[:50]).split()
        new = [{"url": f"https://serve.example/{i}", "title": f"served {i}",
                "content": " ".join(rng.choice(words, size=40))} for i in range(2)]
        status, added, _ = await call("POST", "/documents", {"documents": new})
        if status != 200 or added != {"added": 2, "vectors": N_DOCS + 2}:
            raise AssertionError(f"POST /documents answered {status} {added}")
        found = [(await call("POST", "/search", {"text": d["content"], "top_k": 3,
                                                 "generate": False}))[1] for d in new]
        if [f["similar_documents"][0]["url"] for f in found] != [d["url"] for d in new]:
            raise AssertionError("an added document is not its own first hit")
        status, deleted, _ = await call("DELETE", "/documents",
                                        {"urls": [d["url"] for d in new]})
        if status != 200 or deleted != {"deleted": 2, "documents": N_DOCS}:
            raise AssertionError(f"DELETE /documents answered {status} {deleted}")
        gone = [(await call("POST", "/search", {"text": d["content"], "top_k": 10,
                                                "generate": False}))[1] for d in new]
        if any(h["url"].startswith("https://serve.example/")
               for g in gone for h in g["similar_documents"]):
            raise AssertionError("a deleted document still answers")
        errors = [(await call(*req))[0] for req in (
            ("POST", "/search", None, "{not json"), ("POST", "/search", {"text": " "}),
            ("POST", "/search", {"text": "x", "top_k": 0}), ("GET", "/nowhere"),
            ("GET", "/search"))]
        if errors != [400, 422, 422, 404, 405]:
            raise AssertionError(f"error statuses {errors}")
    finally:
        await app.stop()

    stages = {n: batch_stages(engine, texts[:n]) for n in (1, SERVE_CLIENTS)}
    held = check_served(answers, requests, concurrent_batches, reference)
    held_seq = check_served(seq_answers, seq_requests, seq_batches, reference)
    ref = reference.search(texts[1], top_k=5, where=where)
    if not same_hits(filtered[1]["similar_documents"], ref, RTOL["float32"],
                     serve_tolerance(reference, texts[1:2])):
        raise AssertionError("the filtered answer differs from the CPU copy's")
    return {"concurrent": {**percentiles([a[2] for a in answers]), "clients": SERVE_CLIENTS,
                           "wall_s": concurrent_s,
                           "requests_per_s": len(answers) / concurrent_s, **held},
            "sequential": {**percentiles([a[2] for a in seq_answers]), **held_seq},
            "batch_sizes": dict(sorted(sizes.items())), "batches": sum(sizes.values()),
            "stats_ms": {k: {q[:-1] + "ms": v[q] * 1e3 for q in ("mean_s", "p50_s", "p99_s")}
                         for k, v in stats.items()},
            "search_batch_stages_ms": stages,
            "flat_scan_launches": launches, "sequential_launches": seq_launches,
            "probe_launches": probe_launches,
            "filter_launches": filter_launches,
            "generated_chars": len(answered["generated_response"]),
            "error_statuses": errors}


async def serve_ivf(torch, U, manager, engine, cfg, texts, pool) -> dict:
    """The same server over an IVF index: 64 concurrent requests at top_k 5."""
    import asyncio

    from rag_faiss_embedding_tpu_torch.serve.api import make_app

    loop = asyncio.get_running_loop()
    app = make_app(engine, cfg, manager=manager)
    port = await app.start("127.0.0.1", 0)
    batches = record_batches(engine)
    try:
        U.union_scan.launches = 0  # count this run's launches only
        U.union_scan.variant_launches = {1: 0, 2: 0}
        answers = await asyncio.gather(*[loop.run_in_executor(
            pool, http_json, port, "POST", "/search",
            {"text": t, "top_k": 5, "generate": False}) for t in texts])
        launches = dict(U.union_scan.variant_launches)
        sizes = batch_sizes((await loop.run_in_executor(
            pool, http_json, port, "GET", "/stats"))[1])
    finally:
        await app.stop()
        del engine.search_batch
    if launches[1] <= 0:
        raise AssertionError("the IVF server did not launch the union scan")
    held = check_served(answers, [(t, 5) for t in texts], batches,
                        cpu_copy(torch, manager, engine, backend="pallas"))
    return {**percentiles([a[2] for a in answers]), **held,
            "batch_sizes": dict(sorted(sizes.items())), "union_scan_launches": launches}


def start_cli(args, device):
    """One CLI as a subprocess of this script, started."""
    cmd = [sys.executable, "-m", f"rag_faiss_embedding_tpu_torch.cli.{args[0]}", *args[1:]]
    if device != "cuda":
        cmd += ["--device", device]  # a rehearsal on the CPU; the card is the default
    return time.perf_counter(), subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cli(started, name: str, times: dict) -> str:
    """Wait for a started CLI (300 s at most); its stdout."""
    t, proc = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()  # no-op once it has exited
    times[name] = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli.{name} exited {proc.returncode}: {err[-2000:]}")
    return out


def serve_clis(device: str, workdir: Path) -> dict:
    """pipeline over examples/corpus and selfindex over the port's package
    (at once), then search for one page's text: each a subprocess on the
    default device."""
    from rag_faiss_embedding_tpu_torch.store import Database

    base, self_base, times = workdir / "cli", workdir / "self", {}
    package = ROOT / "rag_faiss_embedding_tpu_torch"
    t = time.perf_counter()
    pipeline = start_cli(["pipeline", "--base-dir", str(base), "--html-root",
                          str(ROOT / "examples" / "corpus")], device)
    selfindex = start_cli(["selfindex", "--base-dir", str(self_base), "--source-dir",
                           str(package)], device)
    finish_cli(pipeline, "pipeline", times)
    entries = json.loads((base / "data" / "documents.json").read_text())
    pages = sorted((ROOT / "examples" / "corpus").glob("*.html"))
    db = Database(base / "data" / "documents.db")
    indexed = db.get_document_count()
    db.close()
    if len(entries) != len(pages) or indexed != len(pages):
        raise AssertionError(f"pipeline indexed {indexed} of {len(pages)} pages")
    pick = entries[2]
    out = finish_cli(start_cli(["search", "--base-dir", str(base), pick["content"]], device),
                     "search", times)
    rows = out[out.index("\n-") + 1:].splitlines()[1:]  # under the table's rule
    if not rows or rows[0].split()[1] != pick["title"]:
        raise AssertionError(f"cli.search did not put {pick['title']} first:\n{out}")
    finish_cli(selfindex, "selfindex", times)
    db = Database(self_base / "data" / "documents.db")
    n_self = db.get_document_count()
    db.close()
    n_py = len(list(package.rglob("*.py")))
    if n_self != n_py:
        raise AssertionError(f"selfindex stored {n_self} documents for {n_py} .py files")
    return {"pipeline_documents": indexed, "search_first_title": pick["title"],
            "selfindex_documents": n_self, "seconds": times,
            "wall_s": time.perf_counter() - t}


def serve_phase(torch, F, U, device: str = "cuda") -> dict:
    """The port's HTTP server in-process on the card at full MiniLM-L6 width
    over the slice's 4,096 documents: K1 through the micro-batcher (flat)
    and K2 (IVF), then the CLIs as subprocesses."""
    import asyncio

    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    import numpy as np

    t0 = time.perf_counter()
    docs = corpus_documents(N_DOCS, SEED)
    _, queries, batch_queries = slice_requests(docs)
    rng = np.random.default_rng(SEED + 16)
    texts = queries + batch_queries  # the slice's, then random documents' texts
    texts += [docs[int(i)]["content"]
              for i in rng.integers(0, N_DOCS, SERVE_REQUESTS - len(texts))]
    out = {"phase": "serve"}
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir, \
            concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        managers = []
        for kind in ("flat", "ivf"):
            cfg = Config(base_dir=Path(workdir) / kind, model_name="chip-smoke-random-init",
                         index_kind=kind, ivf_nlist=64, serve_max_batch=64,
                         serve_watchdog_interval_s=0)
            embedder = managers[0][0].embedder if managers else None
            manager = RAGManager(config=cfg, embedder=embedder, device=device)
            if manager.initialize_database(docs) != N_DOCS:
                raise AssertionError(f"the {kind} manager did not ingest {N_DOCS} documents")
            engine = QueryEngine(manager.db, manager.vector_store, manager.embedder,
                                 generator=AnswerGenerator(backend="extractive"))
            managers.append((manager, engine, cfg))
        (fm, fe, fcfg), (im, ie, icfg) = managers
        out["flat"] = asyncio.run(serve_flat(torch, F, fm, fe, fcfg, docs, texts, pool))
        out["ivf"] = asyncio.run(serve_ivf(torch, U, im, ie, icfg,
                                           texts[:IVF_SERVE_REQUESTS], pool))
        for manager, _, _ in managers:
            manager.cleanup()
        out["clis"] = serve_clis(device, Path(workdir))
    out["wall_s"] = time.perf_counter() - t0
    return out


def bf16_encoder_check(torch, embedder, cpu_pipe, texts) -> dict:
    """The encoder's bf16 compute mode at full width on the card, with the
    slice's weights: its embeddings of ``texts`` against the float32 CPU
    pipeline's by cosine (> 0.99, the JAX package's bar), and its device
    time at 1 / 16 / 32 rows beside the float32 encoder's."""
    import numpy as np

    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline
    from rag_faiss_embedding_tpu_torch.models import convert

    cfg = dataclasses.replace(embedder.cfg, dtype="bfloat16")
    pipe = EmbeddingPipeline(
        params=convert.to_flax_params(embedder.model.state_dict(), embedder.cfg), cfg=cfg,
        tokenizer=embedder.tokenizer, max_seq_length=embedder.max_seq_length,
        device=torch.device("cuda"))
    got, want = pipe.generate_embeddings(texts), cpu_pipe.generate_embeddings(texts)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    if not np.isfinite(got).all() or float(cos.min()) <= 0.99:
        raise AssertionError(f"bf16 encoder cosine to the f32 CPU pipeline {cos.min()}")
    ids, mask = embedder.tokenizer.encode_batch(texts[:32], embedder.max_seq_length)
    ids = np.pad(ids, ((0, 32 - len(ids)), (0, 0)), constant_values=embedder.tokenizer.pad_id)
    mask = np.pad(mask, ((0, 32 - len(mask)), (0, 0)))
    return {"texts": len(texts), "cosine_min_vs_f32_cpu": float(cos.min()),
            "seq_bucket": int(ids.shape[1]),
            "bf16_ms_by_rows": {r: cuda_ms(torch, lambda: pipe._forward(ids[:r], mask[:r]))
                                for r in (1, 16, 32)},
            "f32_ms_by_rows": {r: cuda_ms(torch, lambda: embedder._forward(ids[:r], mask[:r]))
                               for r in (1, 16, 32)}}


# ----------------------------------------------------------------- phase 16
# the JAX record's 10M IVF-PQ shape with refine (benchmarks/scale10m.py)
CHUNKED_N, CHUNKED_CHUNK, CHUNKED_NLIST, CHUNKED_M = 10 * (1 << 20), 1 << 19, 16384, 48
CHUNKED_NPROBES = (8, 16, 32)
ASSIGN_POINT_CHUNK = 65536  # ops/kmeans.assign's score-tile rows


def chunk_source(torch):
    """bench.py's distribution (8,192 Gaussian modes, row = mode + 0.7
    noise) as a pure function of (start, size), made on the card: the same
    arguments give the same rows, so the corpus is stored nowhere."""
    cuda = torch.device("cuda")
    centers = torch.randn(IVF_MODES, IVF_DIM, device=cuda,
                          generator=torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda")

    def source(start: int, size: int):
        # a 32-bit seed per (start, size): the CPU generator keeps 32 bits
        gen.manual_seed(int.from_bytes(hashlib.blake2b(
            f"{SEED}:{start}:{size}".encode(), digest_size=4).digest(), "little"))
        mode = torch.randint(0, IVF_MODES, (size,), generator=gen, device=cuda)
        rows = torch.randn(size, IVF_DIM, generator=gen, device=cuda).mul_(0.7)
        return rows.add_(centers[mode])

    return source


class PeakBySourceCall:
    """A ``source`` that records its calls and the device's peak memory in
    the window after each call (the work on what it returned), so the
    build's peak splits by stage."""

    def __init__(self, torch, source):
        self.torch, self.source, self.calls, self.peaks = torch, source, [], []

    def __call__(self, start, size):
        self.close()
        self.calls.append((start, size))
        return self.source(start, size)

    def close(self):
        if self.calls:
            self.peaks.append(self.torch.cuda.max_memory_allocated())
        self.torch.cuda.reset_peak_memory_stats()


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def resident_bytes(idx) -> dict:
    """Device bytes a built IVF index holds, by part."""
    p = idx._pending
    return {
        "codes": tensor_bytes(idx._sorted_vecs, idx._sorted_scales),
        "norms_ids_map": tensor_bytes(idx._sorted_sq, idx._sorted_ids, idx._shadow_pos,
                                      idx._offsets, idx._lengths),
        "shadow": tensor_bytes(idx._sorted_shadow, idx._sorted_shadow_scales,
                               idx._sorted_shadow_sq),
        "pending": tensor_bytes(p._buf, p._sq, p._scales),
        "quantizers": tensor_bytes(idx.centroids, idx._cent_store, idx._cent_sq,
                                   idx.pq_codebooks, idx._assign_bias),
    }


def host_rss_bytes() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return -1


def streamed_truth(torch, F, source, queries, n: int, chunk: int, k: int = 10,
                   dead=None):
    """The exact float32 top-k of ``queries`` over ``source``'s rows,
    streamed chunk by chunk through the flat-scan kernel and merged; rows
    marked in ``dead`` ((n,) bool) never return."""
    from rag_faiss_embedding_tpu_torch.ops.distance import sqnorms

    best_v = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.long, device=queries.device)
    for start in range(0, n, chunk):
        rows = source(start, min(chunk, n - start))
        v, i = F.flat_search(queries, rows, k, db_sq=sqnorms(rows), dead=None if dead is None
                             else dead[start:start + rows.shape[0]])
        i = torch.where(i >= 0, i.long() + start, -1)
        cat_v, cat_i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
        best_v, pos = torch.topk(cat_v, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    return best_v, best_i


def code_near_ties(torch, idx, other_codes, source_rows) -> dict:
    """Codes of ``idx`` that differ from ``other_codes`` on live slots, each
    checked to be a near tie: its two codewords' float64 distances to the
    row's residual sub-vector agree within 1e-5 of the terms they sum."""
    live = idx._sorted_ids >= 0
    differ = (idx._sorted_vecs != other_codes) & live[:, None]
    slots, subs = torch.nonzero(differ, as_tuple=True)
    worst = 0.0
    if slots.numel():
        rows = source_rows[idx._sorted_ids[slots].long()].double()
        lists = (slots // idx._window).long()
        dsub = idx.dim // idx.pq_m
        resid = (rows - idx.centroids[lists].double()).view(-1, idx.pq_m, dsub)
        r = resid[torch.arange(len(subs), device=slots.device), subs]
        cb = idx.pq_codebooks.double()
        ca = cb[subs, idx._sorted_vecs[slots, subs].long()]
        cb_ = cb[subs, other_codes[slots, subs].long()]
        da, db = ((r - ca) ** 2).sum(-1), ((r - cb_) ** 2).sum(-1)
        scale = (r ** 2).sum(-1) + torch.maximum((ca ** 2).sum(-1), (cb_ ** 2).sum(-1))
        worst = float(((da - db).abs() / scale).max())
        if worst > 1e-5:
            raise AssertionError(f"a chunked-built code differs from the dense build's "
                                 f"away from a tie ({worst})")
    return {"codes_differing": int(slots.numel()), "codes_live": int(live.sum()) * idx.pq_m,
            "worst_tie_gap_rel": worst}


def one_m_builds(torch, U, coarse) -> dict:
    """Three chunked builds at 1M on phase 6's rows (chunks of 524,288): IVF-PQ
    with ``balance="spill"`` pinned to a dense build's training, slot for slot
    against it; ``balance="reassign"`` at cap_factor 1.3; dense bf16 storage
    on phase 6's centroids through the union-scan kernel."""
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at
    from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S

    cuda = torch.device("cuda")
    db, queries = bench_rows(torch)
    flat = FlatIndex(IVF_DIM, capacity=IVF_N, device=cuda)
    flat.add(db)
    _, truth = flat.search(queries, 10)
    del flat
    src = lambda s, z: db[s:s + z]
    pq_kw = dict(nlist=IVF_NLIST, pq_m=CHUNKED_M, train_iters=10, device=cuda)
    out = {}

    def pinned(idx, centroids):
        idx.centroids, idx.is_trained = centroids, True
        return idx

    # spill: the chunked build equals a dense build with the same training
    t0 = time.perf_counter()
    dense = pinned(IVFFlatIndex(IVF_DIM, balance="spill", **pq_kw), coarse)
    dense.build(db)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    chunked = pinned(IVFFlatIndex(IVF_DIM, balance="spill", **pq_kw), coarse)
    chunked.pq_codebooks = dense.pq_codebooks
    t0 = time.perf_counter()
    chunked.build_chunked(src, n=IVF_N, chunk_size=CHUNKED_CHUNK)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    if (chunked._window, chunked._n_spill) != (dense._window, dense._n_spill) or \
            not torch.equal(chunked._sorted_ids, dense._sorted_ids):
        raise AssertionError("the chunked spill build's slots differ from the dense build's")
    ties = code_near_ties(torch, chunked, dense._sorted_vecs, db)
    a, b = dense.search(queries, 10, nprobe=16), chunked.search(queries, 10, nprobe=16)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("the chunked and dense builds search differently")
    out["spill_vs_dense"] = {"dense_build_s": dense_s, "chunked_build_s": chunked_s,
                             "window": chunked._window, "spill_rows": chunked._n_spill,
                             "searches_identical": True, **ties,
                             "build_stats": chunked.build_stats}
    codebooks = dense.pq_codebooks
    del dense, chunked

    # reassign at the 100M setting's cap
    ra = pinned(IVFFlatIndex(IVF_DIM, balance="reassign", **pq_kw), coarse)
    ra.pq_codebooks, ra.cap_factor = codebooks, 1.3
    t0 = time.perf_counter()
    ra.build_chunked(src, n=IVF_N, chunk_size=CHUNKED_CHUNK)
    torch.cuda.synchronize()
    ra_s = time.perf_counter() - t0
    cap = ra._reassign_cap(IVF_N / IVF_NLIST)
    built_ids = ra._sorted_ids[ra._sorted_ids >= 0]
    placed = torch.zeros(IVF_N, dtype=torch.bool, device=cuda)
    placed[built_ids.long()] = True
    pend = torch.as_tensor(ra._pending_rowids, device=cuda).long()
    if ra.ntotal != IVF_N or ra._window > cap or built_ids.numel() + pend.numel() != IVF_N \
            or bool(placed[pend].any()) or ra._pending.ntotal != ra._n_spill:
        raise AssertionError(f"reassign build: ntotal {ra.ntotal}, window {ra._window} "
                             f"(cap {cap}), {ra._n_spill} spilled")
    self_hit = None
    if pend.numel():
        _, got = ra.search(db[pend[:256]], 1)
        self_hit = float((got[:, 0].long() == pend[:256]).float().mean())
        if self_hit < 1.0:
            raise AssertionError(f"spilled rows found themselves {self_hit}")
    out["reassign"] = {"build_s": ra_s, "cap_factor": 1.3, "cap": cap, "window": ra._window,
                       "spill_rows": ra._n_spill, "spilled_self_query_top1": self_hit,
                       "recall@10_q1024_nprobe16": recall_at(
                           ra.search(queries, 10, nprobe=16)[1], truth),
                       "build_stats": ra.build_stats}
    del ra

    # dense bf16 storage through the union-scan kernel
    bf = pinned(IVFFlatIndex(IVF_DIM, nlist=IVF_NLIST, dtype="bfloat16", balance="spill",
                             train_iters=10, device=cuda), coarse)
    t0 = time.perf_counter()
    bf.build_chunked(src, n=IVF_N, chunk_size=CHUNKED_CHUNK)
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    U.union_scan.launches = 0  # the path's launches
    U.union_scan.variant_launches = {1: 0, 2: 0}
    _, ids = bf.search(queries, 10, nprobe=16)
    torch.cuda.synchronize()
    launches = U.union_scan.variant_launches[1]
    bf.backend = "xla"
    _, plain_ids = bf.search(queries, 10, nprobe=16)
    bf.backend = "auto"
    rec, plain_rec = recall_at(ids, truth), recall_at(plain_ids, truth)
    if launches <= 0 or rec < RECALL_MIN or rec < plain_rec - RECALL_SLACK:
        raise AssertionError(f"chunked bf16: {launches} launches, recall@10 {rec} "
                             f"(plain {plain_rec})")
    args, disp = union_args(S, bf, queries, 10, 1, 16)
    err, mism = union_check(torch, U, bf, args, 10)
    out["bf16"] = {"build_s": bf_s, "window": bf._window, "spill_rows": bf._n_spill,
                   "recall@10_q1024_nprobe16": rec, "plain_recall@10": plain_rec,
                   "union_scan_v1_launches": launches, "max_abs_err": err,
                   "id_mismatch": mism, "ms": cuda_ms(torch, lambda: bf.search(queries, 10,
                                                                               nprobe=16), 5),
                   "build_stats": bf.build_stats}
    del bf, db
    torch.cuda.empty_cache()
    return out


def chunked_phase(torch, F, U, PD, coarse) -> dict:
    """The 10M IVF-PQ chunked build (refine bf16), its memory, recall and
    searches; then the three 1M builds."""
    import resource

    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex

    cuda = torch.device("cuda")
    source = chunk_source(torch)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    base = source(0, CHUNKED_CHUNK)  # queries: corpus rows + 0.3 noise, as bench.py
    queries = base[torch.randint(0, CHUNKED_CHUNK, (IVF_Q,), generator=g, device=cuda)]
    queries += 0.3 * torch.randn(IVF_Q, IVF_DIM, generator=g, device=cuda)
    del base
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    idx = IVFFlatIndex(IVF_DIM, nlist=CHUNKED_NLIST, nprobe=16, pq_m=CHUNKED_M,
                       train_iters=10, rerank=True, refine_dtype="bfloat16",
                       rerank_depth=128, balance="spill", device=cuda)
    tracked = PeakBySourceCall(torch, source)
    before = torch.cuda.memory_allocated()
    rss_before = host_rss_bytes()
    t0 = time.perf_counter()
    tracked.close()  # peak window from here
    idx.build_chunked(tracked, n=CHUNKED_N, chunk_size=CHUNKED_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tracked.close()
    n_chunks = -(-CHUNKED_N // CHUNKED_CHUNK)
    stages = ["train"] * n_chunks + ["assign"] * n_chunks + ["pq_train"] + \
        ["encode"] * n_chunks + ["shadow"] * n_chunks
    expected = [(s, min(CHUNKED_CHUNK, CHUNKED_N - s))
                for s in range(0, CHUNKED_N, CHUNKED_CHUNK)]
    if len(tracked.calls) != len(stages) or tracked.calls[n_chunks:2 * n_chunks] != expected:
        raise AssertionError(f"unexpected source calls: {tracked.calls[:4]}...")
    peak_by_stage = {}
    for stage, peak in zip(stages, tracked.peaks):
        peak_by_stage[stage] = max(peak_by_stage.get(stage, 0), peak - before)
    peak = max(peak_by_stage.values())
    resident = resident_bytes(idx)
    working = peak - sum(resident.values())
    # what the build's transients can hold, from chunk_size and the score
    # tile, not n: four (point_chunk, nlist) float32 tiles, four float32
    # chunks, two copies of the training sample (64 rows per list)
    tile = ASSIGN_POINT_CHUNK * CHUNKED_NLIST * 4
    chunk_bytes = CHUNKED_CHUNK * IVF_DIM * 4
    sample = idx.train_sample_per_list * CHUNKED_NLIST * IVF_DIM * 4
    bound = 4 * tile + 4 * chunk_bytes + 2 * sample
    memory = {"peak_bytes": peak, "peak_by_stage_bytes": peak_by_stage,
              "resident_bytes": resident, "working_set_bytes": working,
              "working_set_bound_bytes": bound,
              "bound_terms": {"score_tile": tile, "chunk_f32": chunk_bytes,
                              "train_sample_f32": sample},
              "dense_build_corpus_f32_bytes": CHUNKED_N * IVF_DIM * 4,
              "host_rss_before_bytes": rss_before, "host_rss_after_bytes": host_rss_bytes(),
              "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}

    F.flat_search.launches = 0  # the ground truth's launches
    _, truth = streamed_truth(torch, F, source, queries, CHUNKED_N, CHUNKED_CHUNK)
    torch.cuda.synchronize()
    truth_launches = F.flat_search.launches

    single = queries[:64]
    PD.decode.launches, PD.decode.rows = 0, []  # the searches' launches
    searches = []
    for nprobe in CHUNKED_NPROBES:
        v, ids = idx.search(queries, 10, nprobe=nprobe)
        ids1 = torch.cat([idx.search(single[i:i + 1], 10, nprobe=nprobe)[1]
                          for i in range(len(single))])
        searches.append({
            "nprobe": nprobe,
            "recall@10_q1024": recall_at(ids, truth), "recall@1_q1024": float(
                (ids[:, 0].long() == truth[:, 0]).float().mean()),
            "recall@10_q1": recall_at(ids1, truth[:64]), "recall@1_q1": float(
                (ids1[:, 0].long() == truth[:64, 0]).float().mean()),
            "ms_q1": cuda_ms(torch, lambda: idx.search(single[:1], 10, nprobe=nprobe)),
            "ms_q1024": cuda_ms(torch, lambda: idx.search(queries, 10, nprobe=nprobe), 5, 1),
        })
        if not (bool((ids >= 0).all()) and bool(torch.isfinite(v).all())):
            raise AssertionError(f"a 10M search at nprobe {nprobe} returned missing slots")
    torch.cuda.synchronize()
    k4_launches, k4_rows = PD.decode.launches, PD.decode.rows[:PD.decode.launches]
    PD.decode.rows = None
    kernel_out = idx.search(queries, 10, nprobe=16)
    idx.backend = "xla"
    plain_out = idx.search(queries, 10, nprobe=16)
    idx.backend = "auto"
    if not all(torch.equal(a, b) for a, b in zip(kernel_out, plain_out)):
        raise AssertionError("10M: the decode kernel and the plain decode disagree")
    result = {"phase": "chunked", "N": CHUNKED_N, "D": IVF_DIM, "nlist": CHUNKED_NLIST,
              "pq_m": CHUNKED_M, "chunk_size": CHUNKED_CHUNK, "refine_dtype": "bfloat16",
              "rerank_depth": idx.rerank_depth, "balance": "spill", "build_s": build_s,
              "build_stats": {k: v for k, v in idx.build_stats.items() if k != "train"},
              "train_stats": idx.build_stats.get("train"), "window": idx._window,
              "spill_rows": idx._n_spill, "memory": memory, "searches": searches,
              "kernel_equals_plain_decode_q1024_nprobe16": True,
              "path_launches": {"flat_scan": truth_launches, "pq_decode": k4_launches},
              "pq_decode_rows_per_launch": rows_histogram(k4_rows)}
    del idx, kernel_out, plain_out, truth
    torch.cuda.empty_cache()
    if working > bound:
        emit(result)
        raise AssertionError(f"chunked build working set {working} B over its bound {bound} B")
    result["builds_1m"] = one_m_builds(torch, U, coarse)
    result["path_launches"]["union_scan_v1"] = result["builds_1m"]["bf16"][
        "union_scan_v1_launches"]
    if min(result["path_launches"].values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {result['path_launches']}")
    return result


# ----------------------------------------------------------------- phase 17
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LEN, TRAIN_LR, TRAIN_VOCAB = 200, 32, 128, 2e-5, 8192
CLI_TRAIN_STEPS = 20
GRAD_FLOOR = 1e-6  # 100 x AdamW's eps


def step_tensors(state) -> tuple:
    """A training state's weights and AdamW first moments in the one-card
    layout (a mesh state gathers its slices), copied to the host."""
    host = lambda t: t.detach().to("cpu", copy=True).float()
    weights = {k: host(v) for k, v in state.params.state_dict().items()}
    opt = state.opt_state.state_dict()["state"]
    return weights, {k: host(opt[i]["exp_avg"]) for i, k in enumerate(weights)}


def hold_step(torch, before, a, b) -> dict:
    """Two states one step on from one state: ``before`` is its (weights,
    first moments, None at the start), ``a`` and ``b`` each (loss, weights,
    first moments). The gradient is read back from the moments (m = 0.9 m'
    + 0.1 g). The loss within 1e-4 relative; each gradient tensor within
    1e-4 of its largest entry, or of 1e-2 x the model's largest where that
    is more (a tensor whose exact gradient is zero holds the rounding of
    terms that cancel); every weight within lr / 100, but where a gradient
    is below GRAD_FLOOR (100 x Adam's eps) in either state: Adam's step is
    lr x m / (sqrt(v) + eps), so there float32 rounding in g (the attention
    key biases' whole gradient: a softmax does not see a shift common to a
    query's logits) moves the weight by up to lr. Those are held to 1.01 x
    lr of where they were in both states, and counted."""
    w0, m0 = before
    grads = []
    for _, _, m in (a, b):
        grads.append({k: (m[k] - (0.9 * m0[k] if m0 else 0.0)) / 0.1 for k in m})
    (l_a, w_a, _), (l_b, w_b, _) = a, b
    g_a, g_b = grads
    rel = abs(l_b - l_a) / abs(l_a)
    worst = {"grad_rel": (0.0, None), "weight": (0.0, None), "noise_move": (0.0, None)}
    n_noise = 0
    g_model = max(float(g.abs().max()) for g in g_a.values())
    for name in w_a:
        # a tensor's own largest entry, or the rounding of the model's
        # largest gradient terms where they cancel (the key biases)
        scale = max(float(g_a[name].abs().max()), 1e-2 * g_model)
        g_err = float((g_b[name] - g_a[name]).abs().max()) / scale
        noise = torch.minimum(g_b[name].abs(), g_a[name].abs()) < GRAD_FLOOR
        n_noise += int(noise.sum())
        w_err = (w_b[name] - w_a[name]).abs()
        move = max(float((w - w0[name]).abs()[noise].max()) if noise.any() else 0.0
                   for w in (w_b[name], w_a[name]))
        w_err = float(w_err[~noise].max()) if (~noise).any() else 0.0
        for key, val in (("grad_rel", g_err), ("weight", w_err), ("noise_move", move)):
            if val > worst[key][0]:
                worst[key] = (val, name)
    if rel > 1e-4 or worst["grad_rel"][0] > 1e-4 or worst["weight"][0] > TRAIN_LR / 100 \
            or worst["noise_move"][0] > 1.01 * TRAIN_LR:
        raise AssertionError(f"one step: loss rel {rel}, worst {worst}")
    return {"loss_rel_diff": rel, "grad_max_rel_diff": worst["grad_rel"],
            "weight_max_abs_diff": worst["weight"], "weight_bound": TRAIN_LR / 100,
            "grad_floor": GRAD_FLOOR, "weights_below_grad_floor": n_noise,
            "weights": sum(w.numel() for w in w_a.values()),
            "below_floor_max_move": worst["noise_move"], "below_floor_bound": 1.01 * TRAIN_LR}


def one_step_card_vs_cpu(torch, T, cfg, params, batch) -> dict:
    """One training step from the same parameters and batch on the card and
    on the CPU, held to each other by ``hold_step``."""
    from rag_faiss_embedding_tpu_torch.models.convert import load_flax_params

    out = []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        run, state = T.make_train_step(cfg, learning_rate=TRAIN_LR, params=params, device=dev)
        t0 = time.perf_counter()
        state, m = run(state, batch)
        loss = float(m["loss"])
        out.append((loss, time.perf_counter() - t0, *step_tensors(state)))
    (l_cpu, s_cpu, w_cpu, m_cpu), (l_card, s_card, w_card, m_card) = out
    held = hold_step(torch, (load_flax_params(params), None), (l_cpu, w_cpu, m_cpu),
                     (l_card, w_card, m_card))
    return {"loss_card": l_card, "loss_cpu": l_cpu, **held,
            "step_s_card_first": s_card, "step_s_cpu": s_cpu}


MESH_SHAPE = {"data": 2, "model": 2}  # on four repeated positions of the one card
MESH_TIMED_STEPS = 10


def timed_steps(torch, run, state, batches) -> tuple:
    """Steps over ``batches``, each between CUDA events: (state, losses,
    ms per step)."""
    losses, events = [], []
    for b in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = run(state, b)
        end.record()
        events.append((start, end))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return state, losses, [s.elapsed_time(e) for s, e in events]


def mesh_train_phase(torch, T, cfg, params, batches, docs, workdir: Path) -> dict:
    """Data- and tensor-parallel training on a ``MESH_SHAPE`` mesh over
    four repeated positions of the card, from the parameters and batches of
    the one-card step: the first step held to the one-card step on the card
    by ``hold_step``, the next two's losses within 1e-4 relative, then
    MESH_TIMED_STEPS more of each, timed by CUDA events; a checkpoint saved
    from the mesh restored on one card (the state bit for bit) and its next
    step held to the mesh's next step by ``hold_step``; ``cli.train.train``
    over four repeated positions builds and logs JAX's {data 2, model 2}."""
    import logging

    from rag_faiss_embedding_tpu_torch.cli import train as cli_train
    from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
    from rag_faiss_embedding_tpu_torch.models.convert import load_flax_params
    from rag_faiss_embedding_tpu_torch.parallel.checkpoint import TrainCheckpointer

    cuda = torch.device("cuda")
    mesh = make_mesh(MESH_SHAPE, devices=[cuda] * 4)
    runs = {}
    for label, where in (("one_card", {"device": cuda}), ("mesh", {"mesh": mesh})):
        run, state = T.make_train_step(cfg, learning_rate=TRAIN_LR, params=params, **where)
        state, first_loss, first_ms = timed_steps(torch, run, state, batches[:1])
        after_first = (first_loss[0], *step_tensors(state))
        state, losses, ms = timed_steps(torch, run, state, batches[1:3])
        runs[label] = {"run": run, "state": state, "after_first": after_first,
                       "losses": first_loss + losses, "ms": first_ms + ms}
    one, on_mesh = runs["one_card"], runs["mesh"]
    if not isinstance(on_mesh["state"].params, T.MeshEncoder):
        raise AssertionError("the mesh step did not run on the mesh")
    first = hold_step(torch, (load_flax_params(params), None), one["after_first"],
                      on_mesh["after_first"])
    rel = [abs(a - b) / abs(a) for a, b in zip(one["losses"], on_mesh["losses"])]
    if max(rel) > 1e-4:
        raise AssertionError(f"mesh vs one card: losses {on_mesh['losses']} / {one['losses']}")

    # a checkpoint from the mesh, restored on one card
    ckpt = TrainCheckpointer(workdir / "mesh_ckpt")
    ckpt.save(on_mesh["state"])
    run_one, template = T.make_train_step(cfg, learning_rate=TRAIN_LR, device=cuda)
    restored = ckpt.restore(template)
    w_saved, m_saved = step_tensors(on_mesh["state"])
    w_rest, m_rest = step_tensors(restored)
    if restored.step != 3 or any(not torch.equal(w_saved[k], w_rest[k]) or
                                 not torch.equal(m_saved[k], m_rest[k]) for k in w_saved):
        raise AssertionError("the mesh checkpoint did not restore bit for bit on one card")
    nxt = batches[3 % len(batches)]
    after = []
    for run, state in ((on_mesh["run"], on_mesh["state"]), (run_one, restored)):
        state, m = run(state, nxt)
        after.append((float(m["loss"]), *step_tensors(state)))
    resumed = hold_step(torch, (w_saved, m_saved), *after)
    del restored, template

    # steady ms per step, one card and mesh in turns
    timed = {}
    for label in ("one_card", "mesh", "mesh", "one_card"):
        r = runs[label]
        cycle = [batches[i % len(batches)] for i in range(MESH_TIMED_STEPS // 2)]
        r["state"], _, ms = timed_steps(torch, r["run"], r["state"], cycle)
        timed.setdefault(label, []).extend(ms)
    del runs
    torch.cuda.empty_cache()

    # cli.train.train over four positions of the card
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("rag_faiss_embedding_tpu_torch.cli.train")
    logger.addHandler(handler)
    t0 = time.perf_counter()
    try:
        cli_train.train(docs[:512], steps=3, batch_size=TRAIN_BATCH, max_len=TRAIN_LEN,
                        learning_rate=TRAIN_LR, vocab_size=TRAIN_VOCAB, device=[cuda] * 4)
    finally:
        logger.removeHandler(handler)
    cli_s = time.perf_counter() - t0
    logged = [r.getMessage() for r in records if r.getMessage().startswith("mesh:")]
    if logged != [f"mesh: {MESH_SHAPE}"]:
        raise AssertionError(f"cli.train over four positions logged {logged}")
    return {"shape": MESH_SHAPE, "devices": [str(d) for d in mesh.devices.flat],
            "first_step_vs_one_card": first, "loss_rel_diff_3_steps": rel,
            "losses_mesh": on_mesh["losses"], "losses_one_card": one["losses"],
            "ms_first_3_mesh": on_mesh["ms"], "ms_first_3_one_card": one["ms"],
            "ms_per_step_median_mesh": statistics.median(timed["mesh"]),
            "ms_per_step_median_one_card": statistics.median(timed["one_card"]),
            "timed_steps_each": len(timed["mesh"]),
            "checkpoint_mesh_to_one_card": {"bit_exact": True, "next_step": resumed},
            "cli": {"logged": logged[0], "seconds": cli_s, "documents": 512, "steps": 3}}


def train_phase(torch, F, workdir: Path) -> dict:
    """Full-width MiniLM-L6 training on the card: one step against the CPU,
    ``cli.train.train`` for 200 steps with a checkpoint, a resume from it
    equal bit for bit to training on, then ``cli.train`` as a subprocess and
    a ``RAGManager`` serving the slice's requests with what it wrote."""
    import itertools

    import numpy as np

    from rag_faiss_embedding_tpu_torch.cli import train as cli_train
    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params, import_params
    from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer
    from rag_faiss_embedding_tpu_torch.parallel import train as T
    from rag_faiss_embedding_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    pairs = cli_train.make_pairs(docs, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    tokenizer = WordPieceTokenizer.train([p[0] for p in pairs] + [p[1] for p in pairs],
                                         vocab_size=TRAIN_VOCAB)
    vocab_s = time.perf_counter() - t0
    cfg = MiniLMConfig(vocab_size=tokenizer.vocab_size)
    first_batches = cli_train.batch_iterator(pairs, tokenizer, TRAIN_BATCH, TRAIN_LEN, SEED)
    batch = next(first_batches)
    step_check = one_step_card_vs_cpu(torch, T, cfg, deterministic_params(cfg), batch)
    t0 = time.perf_counter()
    mesh_check = mesh_train_phase(torch, T, cfg, deterministic_params(cfg),
                                  [batch] + list(itertools.islice(first_batches, 3)), docs,
                                  workdir)
    mesh_check["seconds"] = time.perf_counter() - t0

    # cli.train.train at the CLI's defaults, each step timed by CUDA events
    record = {"events": [], "loss": [], "state": None}
    make = T.make_train_step

    def timed_make_train_step(*args, **kwargs):
        run, state = make(*args, **kwargs)

        def run_timed(state, b):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = run(state, b)
            end.record()
            record["events"].append((start, end))
            record["loss"].append(m["loss"])
            record["state"] = state
            return state, m

        return run_timed, state

    ckpt_dir, params_out = workdir / "ckpt", workdir / "trained" / "encoder_params.npz"
    T.make_train_step = timed_make_train_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        _, tok = cli_train.train(docs, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                                 max_len=TRAIN_LEN, learning_rate=TRAIN_LR,
                                 vocab_size=TRAIN_VOCAB, checkpoint_dir=ckpt_dir,
                                 params_out=params_out, device=cuda)
    finally:
        T.make_train_step = make
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in record["events"]]
    losses = [float(x) for x in record["loss"]]
    ms = statistics.median(step_ms[10:])
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"training did not learn: first 20 {first}, last 20 {last}")

    # resume from the checkpoint: two more steps equal to two from memory
    ckpt = TrainCheckpointer(ckpt_dir)
    tcfg = MiniLMConfig(vocab_size=max(tok.vocab_size, 128))
    run, fresh = T.make_train_step(tcfg, learning_rate=TRAIN_LR, device=cuda)
    restored = ckpt.restore(fresh)
    live = record["state"]
    more = list(itertools.islice(cli_train.batch_iterator(pairs, tok, TRAIN_BATCH, TRAIN_LEN,
                                                          SEED + 1), 2))
    # the card's default kernels are not bit-reproducible from run to run
    # (``rerun_default_max_abs_diff``: the same two steps from the checkpoint
    # twice), so the four compared steps take torch's deterministic
    # algorithms: the check is on what the checkpoint holds
    reruns = []
    for _ in range(2):
        run_again, again = T.make_train_step(tcfg, learning_rate=TRAIN_LR, device=cuda)
        again = ckpt.restore(again)
        for b in more:
            again, _ = run_again(again, b)
        reruns.append(again.params.state_dict())
    rerun_diff = max(float((reruns[0][k] - reruns[1][k]).abs().max()) for k in reruns[0])
    del reruns, again
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    l_live, l_restored = [], []
    try:
        for b in more:
            live, m = run(live, b)
            l_live.append(float(m["loss"]))
        for b in more:
            restored, m = run(restored, b)
            l_restored.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    a, b = live.params.state_dict(), restored.params.state_dict()
    differ = {k: float((a[k] - b[k]).abs().max()) for k in a if not torch.equal(a[k], b[k])}
    exact = l_live == l_restored and restored.step == live.step == TRAIN_STEPS + 2 and \
        not differ
    if ckpt.latest_step() != TRAIN_STEPS or not exact:
        raise AssertionError(f"resume differs from training on: losses {l_live} vs "
                             f"{l_restored}, steps {live.step} / {restored.step}, "
                             f"weights {differ}")
    saved = import_params(params_out)
    if saved["embeddings"]["word_embeddings"]["embedding"].shape != (tcfg.vocab_size, 384):
        raise AssertionError("the exported params do not match the trained config")
    del live, restored, fresh, record
    torch.cuda.empty_cache()

    # the CLI as a user runs it, then a manager serving with what it wrote
    base = workdir / "cli"
    base.mkdir()
    (base / "documents.json").write_text(json.dumps(docs))
    times = {}
    finish_cli(start_cli(["train", "--base-dir", str(base), "--documents",
                          str(base / "documents.json"), "--steps", str(CLI_TRAIN_STEPS)],
                         "cuda"), "train", times)
    cfg_w = Config(base_dir=base)
    F.flat_search.launches = 0  # the served requests' launches
    manager = RAGManager(config=cfg_w, device=cuda)
    n = manager.initialize_database(docs)
    engine = QueryEngine(manager.db, manager.vector_store, manager.embedder,
                         generator=AnswerGenerator(backend="extractive"))
    picks, queries, batch_queries = slice_requests(docs)
    singles = [engine.search(text, top_k=5) for text in queries]
    batch_hits = engine.search_batch(batch_queries, top_k=5)
    torch.cuda.synchronize()
    launches = F.flat_search.launches
    trained = import_params(cfg_w.data_dir / "encoder_params.npz")
    loaded = manager.embedder.model.embeddings.word_embeddings.weight.detach().cpu().numpy()
    if n != N_DOCS or launches < len(queries) + 1 or not all(singles + batch_hits) or \
            not np.array_equal(loaded, trained["embeddings"]["word_embeddings"]["embedding"]):
        raise AssertionError(f"trained manager: {n} documents, {launches} launches")
    self_hits = sum(h[0]["url"] == docs[i]["url"] for h, i in zip(singles, picks))
    manager.cleanup()
    return {"phase": "train", "encoder": dataclasses.asdict(tcfg), "vocab_train_s": vocab_s,
            "one_step_card_vs_cpu": step_check, "mesh": mesh_check,
            "train": {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "max_len": TRAIN_LEN,
                      "lr": TRAIN_LR, "wall_s": train_s, "ms_per_step_median": ms,
                      "ms_per_step_first": step_ms[0],
                      "sequences_per_s": 2 * TRAIN_BATCH / ms * 1e3,
                      "tokens_per_s": 2 * TRAIN_BATCH * TRAIN_LEN / ms * 1e3,
                      "peak_device_bytes": peak, "loss_first20_mean": first,
                      "loss_last20_mean": last, "loss_every_10": losses[::10]},
            "resume_bit_exact": exact, "resume_losses": l_restored,
            "rerun_default_max_abs_diff": rerun_diff,
            "cli": {"seconds": times["train"], "steps": CLI_TRAIN_STEPS, "documents": n,
                    "self_retrieval": f"{self_hits}/8", "flat_scan_launches": launches},
            "path_launches": {"flat_scan": launches}}


# ----------------------------------------------------------------- phase 18
# BASELINE.md config #4 (10M x 384 float32 flat, split over devices) and
# bench.py's 1M IVF shape over the same mesh
SHARDED_N, SHARDED_SHARDS = 10 * (1 << 20), 4
SHARDED_NPROBES = (8, 16)
SHARDED_PQ_M = 48


def sharded_mesh(torch):
    """Every card on a "db" axis where there are several, else
    ``SHARDED_SHARDS`` shards on the one card."""
    from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh

    if torch.cuda.device_count() > 1:
        return make_mesh({"db": torch.cuda.device_count()})
    return make_mesh({"db": SHARDED_SHARDS}, devices=[torch.device("cuda", 0)] * SHARDED_SHARDS)


def shard_bytes(*shard_lists) -> list:
    """Device bytes of each shard, summed over per-shard tensor lists."""
    return [tensor_bytes(*parts) for parts in zip(*shard_lists)]


def held_to_truth(torch, q, rows_of, x_sq_max: float, kv, ki, tv, ti, rtol=RTOL["float32"]):
    """L2 (kv, ki) against the truth (tv, ti): the same missing slots, values
    within rtol x (max ||q||^2 + max ||x||^2) at every slot, and every id
    that differs from the truth's carrying its own float64 distance within
    that tolerance (a near-tie); ``rows_of(ids)`` gives rows by global id.
    Returns (max_abs_err, ids that differ)."""
    atol = rtol * (float((q.double() ** 2).sum(1).max()) + x_sq_max)
    fin = torch.isfinite(tv)
    if not torch.equal(fin, torch.isfinite(kv)) or not torch.equal(ki >= 0, fin):
        raise AssertionError("missing slots differ from the truth's")
    err = float((kv - tv).abs()[fin].max()) if fin.any() else 0.0
    if err > atol:
        raise AssertionError(f"values differ from the truth by {err} (tolerance {atol})")
    differ = (ki.long() != ti.long()) & fin
    if differ.any():
        qi, _ = torch.nonzero(differ, as_tuple=True)
        true = ((q[qi].double() - rows_of(ki[differ].long()).double()) ** 2).sum(-1)
        if not bool(((true - kv[differ].double()).abs() <= atol).all()):
            raise AssertionError("an id that differs from the truth's is not a near-tie")
    return err, int(differ.sum())


def sharded_flat_run(torch, F, mesh) -> dict:
    """BASELINE.md config #4 in ``ShardedFlatIndex``: 10,485,760 x 384
    float32 rows of bench.py's distribution, made on the card chunk by chunk
    (``chunk_source``) and added with the capacity set up front; searches at
    k 10, Q 1 and 1,024, plain, with 30% of the rows removed and under a
    filter, each held to the streamed ground truth; one K1 launch per shard
    per search; the kernel against its plain version on a shard."""
    from rag_faiss_embedding_tpu_torch.parallel import ShardedFlatIndex

    cuda = torch.device("cuda")
    source = chunk_source(torch)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    base = source(0, CHUNKED_CHUNK)  # queries: corpus rows + 0.3 noise, as bench.py
    queries = base[torch.randint(0, CHUNKED_CHUNK, (IVF_Q,), generator=g, device=cuda)]
    queries += 0.3 * torch.randn(IVF_Q, IVF_DIM, generator=g, device=cuda)
    del base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = ShardedFlatIndex(IVF_DIM, mesh, capacity=SHARDED_N)
    for start in range(0, SHARDED_N, CHUNKED_CHUNK):
        idx.add(source(start, min(CHUNKED_CHUNK, SHARDED_N - start)))
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    per = idx._capacity // idx.n_dev
    x_sq_max = max(float(s.max()) for s in idx._sq)

    def rows_of(ids):
        out = torch.empty((ids.numel(), IVF_DIM), device=cuda)
        for j, buf in enumerate(idx._buf):
            m = ids // per == j
            out[m] = buf[(ids[m] % per)].to(cuda)
        return out

    cases = []
    g.manual_seed(SEED + 3)
    gone = torch.randperm(SHARDED_N, generator=g, device=cuda)[: int(0.3 * SHARDED_N)]
    keep = torch.rand(SHARDED_N, generator=g, device=cuda) < 0.5
    for case in ("all rows", "30% removed", "30% removed + filter"):
        dead = None
        if case != "all rows":
            if idx.ndeleted == 0:
                idx.remove_ids(gone.cpu().numpy())
            dead = torch.zeros(SHARDED_N, dtype=torch.bool, device=cuda)
            dead[gone] = True
        kw = {}
        if case.endswith("filter"):
            kw["filter_mask"] = keep
            dead = dead | ~keep
        tv, ti = streamed_truth(torch, F, source, queries, SHARDED_N, CHUNKED_CHUNK,
                                dead=dead)
        torch.cuda.synchronize()
        for nq in (1, IVF_Q):
            F.flat_search.launches = 0  # this search's launches
            kv, ki = idx.search(queries[:nq], 10, **kw)
            torch.cuda.synchronize()
            launches = F.flat_search.launches
            if launches != idx.n_dev:
                raise AssertionError(f"{case}: K1 launched {launches} times over "
                                     f"{idx.n_dev} shards")
            err, mism = held_to_truth(torch, queries[:nq], rows_of, x_sq_max, kv, ki,
                                      tv[:nq], ti[:nq])
            if dead is not None and bool(dead[ki.long()].any()):
                raise AssertionError(f"{case}: a removed or filtered row came back")
            cases.append({"case": case, "Q": nq, "k1_launches": launches,
                          "max_abs_err_vs_truth": err, "id_mismatch_vs_truth": mism,
                          "ms": cuda_ms(torch, lambda: idx.search(queries[:nq], 10, **kw),
                                        5 if nq > 1 else 10)})
    path_launches = sum(c["k1_launches"] for c in cases)
    # K1 against its plain version at a shard's shape
    shard = {}
    for nq in (1, IVF_Q):
        q = queries[:nq]
        err, mism, _ = check_scan(torch, F, q, idx._buf[0], idx._sq[0], 10, "L2")
        shard[f"Q={nq}"] = {
            "N": per, "D": IVF_DIM, "k": 10, "max_abs_err": err, "id_mismatch": mism,
            "ms": cuda_ms(torch, lambda: F.flat_search(q, idx._buf[0], 10, db_sq=idx._sq[0])),
            "plain_ms": cuda_ms(torch, lambda: F.flat_search_reference(
                q, idx._buf[0], 10, db_sq=idx._sq[0]), 3, 1)}
        shard[f"Q={nq}"].update(achieved(flat_work(nq, per, IVF_DIM, 10), shard[f"Q={nq}"]["ms"]))
    profile = search_profile(torch, idx, queries[:1], 8)
    out = {"N": SHARDED_N, "D": IVF_DIM, "dtype": "float32", "shards": idx.n_dev,
           "rows_per_shard": per, "add_s": add_s,
           "shard_bytes": shard_bytes(idx._buf, idx._sq),
           "cases": cases, "path_launches": path_launches,
           "shard_kernel_times": shard, "search_profile_q1": profile,
           "max_abs_err": max(v["max_abs_err"] for v in shard.values())}
    out["total_bytes"] = sum(out["shard_bytes"])
    del idx, queries, keep, gone
    torch.cuda.empty_cache()
    return out


def recall_rows(torch, idx, queries, truth, nprobes, kernels=()):
    """recall@10 at Q 1 (64 single queries) and Q 1,024 at each nprobe, and
    CUDA-event search ms; with the launch count of each wrapper in
    ``kernels`` taken after the recall searches (before the timed ones)."""
    from rag_faiss_embedding_tpu_torch.benchmarks.fused_proto import recall_at

    single = queries[:64]
    rows = []
    for nprobe in nprobes:
        ids1 = torch.cat([idx.search(single[i:i + 1], 10, nprobe=nprobe)[1]
                          for i in range(len(single))])
        _, ids = idx.search(queries, 10, nprobe=nprobe)
        rows.append({"nprobe": nprobe, "recall@10_q1": recall_at(ids1, truth[:64]),
                     "recall@10_q1024": recall_at(ids, truth)})
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    for r in rows:
        nprobe = r["nprobe"]
        r["ms_q1"] = cuda_ms(torch, lambda: idx.search(single[:1], 10, nprobe=nprobe))
        r["ms_q1024"] = cuda_ms(torch, lambda: idx.search(queries, 10, nprobe=nprobe), 5, 1)
    return rows, launches


def shard_union_check(torch, S, U, idx, j: int, q, nprobe: int) -> dict:
    """K2 against its plain version on shard ``j``'s tensors at the union
    scan a search of ``q`` gives that shard (its coarse stage and union)."""
    import types

    disp = idx._dispatch(q.shape[0], nprobe, False)
    if disp["backend"] != "pallas" or disp["interpret"]:
        raise AssertionError(f"the sharded index does not dispatch the kernel: {disp}")
    _, qp, u_all, _ = S._coarse_union(
        q.float(), idx._cent_store[j], idx._cent_sq[j], nprobe=nprobe, metric=idx.metric,
        union_cap=disp["union_cap"], qc=disp["qc"], union_mode=disp["union_mode"])
    args = S.union_scan_args(qp, u_all, idx._vecs[j], idx._sq[j], idx._ids[j], k=10,
                             window=idx._window, metric=idx.metric, pallas_cap=2,
                             pallas_variant=1)
    shard = types.SimpleNamespace(_sorted_ids=idx._ids[j], _sorted_vecs=idx._vecs[j],
                                  ntotal=idx.ntotal)
    err, mism = union_check(torch, U, shard, args, 10)
    return {"shard": j, "Q": q.shape[0], "nprobe": nprobe, "chunks": args["qs"].shape[0],
            "qc": args["qs"].shape[1], "U": args["u_all"].shape[1], "window": idx._window,
            "max_abs_err": err, "id_mismatch": mism, **union_work(torch, U, args, q.shape[0]),
            "ms": cuda_ms(torch, lambda: U.union_scan(**args)),
            "plain_ms": cuda_ms(torch, lambda: U.union_scan_reference(**args))}


def sharded_ivf_run(torch, F, U, PD, mesh, coarse, workdir: Path) -> dict:
    """bench.py's 1M x 384 rows over the mesh in ``ShardedIVFIndex(nlist
    8,192)`` on phase 6's centroids: bf16 (K2 per shard), int8 and IVF-PQ
    (M 48, K4 per shard); recall@10 at nprobe 8 and 16 against the exact
    top-10, each held to a one-card ``IVFFlatIndex`` on the same centroids
    (IVF-PQ: and the same codebooks); the kernel routes against the plain
    ones; then the bf16 index
    saved and reloaded through ``VectorStore``."""
    from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, VectorStore
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops.distance import sqnorms
    from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    cuda = torch.device("cuda")
    db, queries = bench_rows(torch)
    _, truth = F.flat_search(queries, db, 10, db_sq=sqnorms(db))  # exact float32 top-10
    x_sq_max = float(sqnorms(db).max())
    out, launches = {"N": IVF_N, "D": IVF_DIM, "nlist": IVF_NLIST, "shards": mesh.size}, {}
    keep_bf16 = None
    for dtype in ("bfloat16", "int8", "pq"):
        kw = {"pq_m": SHARDED_PQ_M} if dtype == "pq" else {"dtype": dtype}
        t0 = time.perf_counter()
        idx = ShardedIVFIndex(IVF_DIM, mesh, nlist=IVF_NLIST, train_iters=10, **kw)
        idx.centroids = coarse.clone()
        idx.build(db)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        U.union_scan.launches = PD.decode.launches = 0  # this index's searches
        PD.decode.rows = []
        rows, (k2, k4) = recall_rows(torch, idx, queries, truth, SHARDED_NPROBES,
                                     (U.union_scan, PD.decode))
        k4_rows, PD.decode.rows = PD.decode.rows[:k4], None
        n_search = len(SHARDED_NPROBES) * (64 + 1)
        res = {"build_s": build_s, "window": idx._window,
               "spill_rows": sum(idx._spill[3]) if idx._spill is not None else 0,
               "shard_bytes": shard_bytes(idx._vecs, idx._sq, idx._ids,
                                          idx._scales or [None] * idx.n_dev),
               "routes": rows, "searches": n_search, "k2_launches": k2, "k4_launches": k4}
        res["total_bytes"] = sum(res["shard_bytes"])
        if dtype == "pq":
            if k4 < idx.n_dev * n_search:
                raise AssertionError(f"K4 launched {k4} times for {n_search} searches over "
                                     f"{idx.n_dev} shards")
            launches["pq_decode"] = k4
            out["pq_decode_rows_per_launch"] = rows_histogram(k4_rows)
            kern = idx.search(queries, 10, nprobe=8)
            idx.backend = "xla"
            plain = idx.search(queries, 10, nprobe=8)
            idx.backend = "auto"
            if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
                raise AssertionError("sharded IVF-PQ: the decode kernel and the plain decode "
                                     "disagree")
            # K4 at a shard's shape: its first union segment of the first chunk
            disp = idx._dispatch(IVF_Q, 8, False)
            _, _, u_all, _ = S._coarse_union(
                queries.float(), idx._cent_store[0], idx._cent_sq[0], nprobe=8, metric="L2",
                union_cap=disp["union_cap"], qc=disp["qc"], union_mode=disp["union_mode"])
            codes = idx._vecs[0].view(-1, idx._window, SHARDED_PQ_M)[u_all[0].long()]
            cb = idx._pq_operands()[0][0]
            codes = codes.reshape(-1, SHARDED_PQ_M)
            err, ms, plain_ms = decode_check(torch, PD, cb, codes)
            res["shard_decode"] = {"rows": codes.shape[0], "M": SHARDED_PQ_M,
                                   "dtype": str(cb.dtype).removeprefix("torch."),
                                   "max_abs_err": err, "ms": ms,
                                   "device_ms": device_ms(torch, lambda: PD.decode(cb, codes)),
                                   "plain_ms": plain_ms,
                                   **decode_library(torch, PD, cb, codes)}
        one = IVFFlatIndex(IVF_DIM, nlist=IVF_NLIST, train_iters=10, rerank=False, device=cuda,
                           **kw)
        one.centroids, one.is_trained = coarse.clone(), True
        if dtype == "pq":
            one.pq_codebooks = idx.pq_codebooks.clone()  # the same codec on both
        one.build(db)
        res["one_card"] = recall_rows(torch, one, queries, truth, SHARDED_NPROBES)[0]
        res["one_card_window"] = one._window
        del one
        # IVF-PQ without refine has no absolute floor (ADC alone); it is held
        # to the one-card IVF-PQ on the same centroids and codebooks
        floor = 0.0 if dtype == "pq" else RECALL_MIN
        for r, o in zip(rows, res["one_card"]):
            for key in ("recall@10_q1", "recall@10_q1024"):
                if r[key] < floor or r[key] < o[key] - RECALL_SLACK:
                    raise AssertionError(f"sharded {dtype} nprobe {r['nprobe']} {key} "
                                         f"{r[key]} (one card {o[key]})")
        if dtype == "pq":
            out[dtype] = res
            del idx
            continue
        if dtype == "bfloat16":
            if k2 != idx.n_dev * n_search:
                raise AssertionError(f"K2 launched {k2} times for {n_search} searches over "
                                     f"{idx.n_dev} shards")
            launches["union_scan_v1"] = k2
            # the whole search with K2's plain version in the kernel's place,
            # on the same card tensors (bf16 storage: bf16's rtol, as
            # union_check holds K2)
            kv, ki = idx.search(queries, 10, nprobe=8)
            S.union_scan = U.union_scan_reference
            try:
                pv, pi = idx.search(queries, 10, nprobe=8)
            finally:
                S.union_scan = U.union_scan
            err, mism = held_to_truth(torch, queries, lambda ids: db[ids], x_sq_max,
                                      kv, ki, pv, pi, RTOL["bfloat16"])
            res["kernel_vs_plain_version"] = {"max_abs_err": err, "id_mismatch": mism}
            res["shard_kernel_cases"] = [shard_union_check(torch, S, U, idx, j, queries[:nq], p)
                                         for j in (0, idx.n_dev - 1) for nq in (1, IVF_Q)
                                         for p in SHARDED_NPROBES[:1]]
            res["search_profile"] = {f"Q={q.shape[0]}": search_profile(torch, idx, q, reps)
                                     for q, reps in ((queries[:1], 8), (queries, 3))}
            keep_bf16 = idx
        else:
            del idx
        out[dtype] = res
        torch.cuda.empty_cache()
    out["persistence"] = sharded_reload(torch, keep_bf16, mesh, queries, db, x_sq_max,
                                        workdir)
    out["path_launches"] = launches
    del keep_bf16, db
    torch.cuda.empty_cache()
    return out


def sharded_reload(torch, idx, mesh, queries, db, x_sq_max: float, workdir: Path) -> dict:
    """The bf16 sharded IVF saved through ``VectorStore``, reloaded onto the
    same mesh (bit-exact searches, no build) and with no mesh (re-striped
    onto the visible cards: the same ids but at near-ties, on the exact
    chunk body and on the kernel route)."""
    from rag_faiss_embedding_tpu_torch.index import VectorStore
    from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    cuda = torch.device("cuda")
    path = workdir / "sharded_ivf.idx"
    store = VectorStore(dimension=IVF_DIM, index_path=path, index=idx, device=cuda)
    store.doc_ids = list(range(idx.ntotal))
    t0 = time.perf_counter()
    store.save_index()
    save_s = time.perf_counter() - t0
    before = idx.search(queries, 10, nprobe=8)

    def no_build(*a, **k):
        raise AssertionError("a reload onto the saved mesh must not build")

    built, ShardedIVFIndex.build = ShardedIVFIndex.build, no_build
    try:
        t0 = time.perf_counter()
        same = VectorStore(index_path=path, mesh=mesh, device=cuda)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        ShardedIVFIndex.build = built
    after = same.index.search(queries, 10, nprobe=8)
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("a reload onto the same mesh searches differently")
    del same
    t0 = time.perf_counter()
    default = VectorStore(index_path=path, device=cuda)  # every visible card
    restripe_s = time.perf_counter() - t0
    other = default.index
    kernel_route = other.search(queries, 10, nprobe=8)
    for i in (idx, other):
        i.backend = "xla"
    err, mism = held_to_truth(torch, queries, lambda ids: db[ids], x_sq_max,
                              *other.search(queries, 10, nprobe=8),
                              *idx.search(queries, 10, nprobe=8))
    for i in (idx, other):
        i.backend = "auto"
    # the kernel route on the re-striped index against the saved one's:
    # bf16 storage, held as K2 is held to its plain version
    route_err, route_differ = held_to_truth(torch, queries, lambda ids: db[ids], x_sq_max,
                                            *kernel_route, *before, RTOL["bfloat16"])
    out = {"file_bytes": path.stat().st_size, "save_s": save_s, "load_same_mesh_s": load_s,
           "same_mesh_bit_exact": True, "default_mesh_shards": other.n_dev,
           "default_mesh_window": other._window, "load_default_mesh_s": restripe_s,
           "default_mesh_plain_route_vs_saved": {"max_abs_err": err, "id_mismatch": mism},
           "default_mesh_kernel_route_vs_saved": {"max_abs_err": route_err,
                                                  "id_mismatch": route_differ}}
    del default, other
    torch.cuda.empty_cache()
    return out


def hits_agree(a, b, q, rows, row_of, tol: float) -> bool:
    """Two engines' hit lists for query embedding ``q`` agree: equal
    length, distances within ``tol`` slot by slot, and every hit of ``a``
    carrying its own float64 distance to ``q`` within ``tol`` (so ids differ
    only at near-ties); ``rows`` are the index rows, ``row_of`` maps a doc
    id to its row."""
    import numpy as np

    da = np.array([h["distance"] for h in a])
    if len(a) != len(b) or not np.allclose(da, [h["distance"] for h in b], rtol=0, atol=tol):
        return False
    own = ((rows[[row_of[h["id"]] for h in a]].astype(np.float64)
            - q.astype(np.float64)) ** 2).sum(-1)
    return bool(np.allclose(own, da, rtol=0, atol=tol))


def sharded_slice_run(torch, U, mesh, workdir: Path) -> dict:
    """The slice's 4,096 documents in a one-card IVF manager (nlist 64);
    their embeddings in a ``ShardedIVFIndex`` on the same centroids, saved
    with the manager's doc ids and loaded by ``VectorStore(mesh=...)``;
    ``QueryEngine.search`` over it for the slice's requests, with K2 on
    every shard at the default nprobe, gives the one-card engine's answers
    there, and again probing every list on the exact chunk body (where list
    membership, window and spill tiers cannot matter); held by
    ``hits_agree``, to rtol x (max ||q||^2 + max ||x||^2): the two layouts
    sum in other orders."""
    from rag_faiss_embedding_tpu_torch.core.config import Config
    from rag_faiss_embedding_tpu_torch.index import VectorStore
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cuda = torch.device("cuda")
    docs = corpus_documents(N_DOCS, SEED)
    _, queries, batch_queries = slice_requests(docs)
    cfg = Config(base_dir=workdir / "slice", model_name="chip-smoke-random-init",
                 index_kind="ivf", ivf_nlist=64)
    manager = RAGManager(config=cfg, device=cuda)
    manager.initialize_database(docs)
    one = manager.vector_store.index
    nprobe = one.nprobe
    vecs, ids = one.vectors(return_ids=True)
    sharded = ShardedIVFIndex(IVF_DIM, mesh, nlist=one.nlist, nprobe=one.nprobe,
                              dtype=one.dtype_name)
    sharded.centroids = one.centroids.clone()
    sharded.build(vecs, row_ids=ids)
    path = workdir / "slice_sharded.idx"
    store = VectorStore(dimension=IVF_DIM, index_path=path, index=sharded, device=cuda)
    store.doc_ids = list(manager.vector_store.doc_ids)
    store.save_index()
    loaded = VectorStore(index_path=path, mesh=mesh, device=cuda)
    gen = AnswerGenerator(backend="extractive")
    engine = QueryEngine(manager.db, loaded, manager.embedder, generator=gen)
    one_engine = QueryEngine(manager.db, manager.vector_store, manager.embedder, generator=gen)
    texts = queries + batch_queries
    U.union_scan.launches = 0  # the sharded engine's requests
    answers = [engine.search(t, top_k=5) for t in texts]
    torch.cuda.synchronize()
    k2 = U.union_scan.launches
    if k2 != loaded.index.n_dev * len(texts) or any(len(a) != 5 for a in answers):
        raise AssertionError(f"sharded engine: {k2} K2 launches for {len(texts)} requests")
    embs = [manager.embedder.embed_query(t) for t in texts]
    row_of = {d: p for p, d in enumerate(store.doc_ids)}
    tol = RTOL["float32"] * (max(float((e.astype("float64") ** 2).sum()) for e in embs)
                             + float((vecs.astype("float64") ** 2).sum(1).max()))
    at_default = [one_engine.search(t, top_k=5) for t in texts]
    differing = [(t, a, b) for a, b, e, t in zip(answers, at_default, embs, texts)
                 if not hits_agree(a, b, e, vecs, row_of, tol)]
    if differing:  # the hits on both sides, for the record
        emit({"phase": "sharded_slice_mismatch", "tolerance": tol, "answers": [
            {"text": t[:80], "sharded": [(int(h["id"]), float(h["distance"])) for h in a],
             "one_card": [(int(h["id"]), float(h["distance"])) for h in b]}
            for t, a, b in differing]})
        raise AssertionError(f"{len(differing)} sharded answers at the default nprobe differ "
                             "from the one-card engine's")
    for i in (loaded.index, one):
        i.backend, i.nprobe = "xla", i.nlist
    plain = [engine.search(t, top_k=5) for t in texts]
    reference = [one_engine.search(t, top_k=5) for t in texts]
    differ = sum(not hits_agree(a, b, e, vecs, row_of, tol)
                 for a, b, e in zip(plain, reference, embs))
    if differ:
        raise AssertionError(f"{differ} sharded answers differ from the one-card engine's")
    manager.cleanup()
    return {"documents": len(docs), "requests": len(texts), "k2_launches": k2,
            "shards": loaded.index.n_dev, "window": loaded.index._window,
            "nprobe": nprobe, "value_tolerance": tol, "full_probe_answers_equal_one_card": True,
            "default_nprobe_answers_equal_one_card": True,
            "id_mismatch_full_probe": sum(x["id"] != y["id"] for a, b in zip(plain, reference)
                                          for x, y in zip(a, b))}


def sharded_phase(torch, F, U, PD, coarse, workdir: Path) -> dict:
    mesh = sharded_mesh(torch)
    print(f"sharded mesh: {mesh} over {torch.cuda.device_count()} visible device(s)",
          flush=True)
    t0 = time.perf_counter()
    flat = sharded_flat_run(torch, F, mesh)
    flat["run_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = sharded_ivf_run(torch, F, U, PD, mesh, coarse, workdir)
    ivf["run_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sl = sharded_slice_run(torch, U, mesh, workdir)
    sl["run_s"] = time.perf_counter() - t0
    return {"phase": "sharded", "mesh": mesh.shape,
            "mesh_devices": [str(d) for d in mesh.devices.flat],
            "device_count": torch.cuda.device_count(), "flat": flat, "ivf": ivf, "slice": sl,
            "path_launches": {"flat_scan": flat["path_launches"],
                              "union_scan_v1": ivf["path_launches"]["union_scan_v1"]
                              + sl["k2_launches"],
                              "pq_decode": ivf["path_launches"]["pq_decode"]}}


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
    i8 = int8_phase(torch, F, built[0])  # on the bf16 build's coarse quantizer
    emit(i8)
    coarse = built[0].centroids.clone()
    del built
    torch.cuda.empty_cache()
    chunked = chunked_phase(torch, F, U, PD, coarse)
    emit(chunked)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
        sharded = sharded_phase(torch, F, U, PD, coarse, Path(workdir))
    emit(sharded)
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
    emit(int8_slice_phase(torch))
    serve = serve_phase(torch, F, U)
    emit(serve)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as workdir:
        train = train_phase(torch, F, Path(workdir))
    emit(train)
    kp = kernel_probe_phase(torch)
    emit(kp)
    emit(bounds_phase(cases, ivf, pq))

    loaded = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES]
    if loaded:
        raise AssertionError(f"the port pulled in JAX modules: {loaded}")
    flat_q1 = sl["main_path_kernel_times"]["Q=1"]
    v1 = ivf_sl["main_path_kernel_times"]["Q=1"]
    v2 = ivf["kernel_cases"][1]
    shard_k4 = sharded["ivf"]["pq"]["shard_decode"]
    chain = kp["variants"]["chain"]
    flat_paths = {"slice": sl["flat_scan_launches"],
                  "serve": serve["flat"]["flat_scan_launches"]
                  + serve["flat"]["sequential_launches"],
                  "chunked_truth": chunked["path_launches"]["flat_scan"],
                  "train": train["path_launches"]["flat_scan"],
                  "sharded": sharded["path_launches"]["flat_scan"]}
    v1_paths = {"ivf_slice": ivf_sl["union_scan_v1_launches"],
                "serve": serve["ivf"]["union_scan_launches"][1],
                "chunked_bf16": chunked["path_launches"]["union_scan_v1"],
                "sharded": sharded["path_launches"]["union_scan_v1"]}
    pq_paths = {"pq_slice": pq_sl["pq_decode_launches"],
                "chunked": chunked["path_launches"]["pq_decode"],
                "sharded": sharded["path_launches"]["pq_decode"]}
    pq_rows = {"pq_slice": pq_sl["pq_decode_rows_per_launch"],
               "chunked": chunked["pq_decode_rows_per_launch"],
               "sharded": sharded["ivf"]["pq_decode_rows_per_launch"]}
    kernels = [{
        "name": "flat_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(flat_paths.values()),
        "paths": flat_paths,
        "max_abs_err": max(max_err, sharded["flat"]["max_abs_err"],
                           *(v["max_abs_err"] for v in sl["main_path_kernel_times"].values())),
        "ms": flat_q1["ms"], "plain_ms": flat_q1["plain_ms"],
        **achieved(flat_work(1, flat_q1["N"], flat_q1["D"], flat_q1["k"]), flat_q1["ms"]),
        "library_ms": None,
    }, {
        "name": "union_scan v1", "route": "cuda", "source": UNION_SOURCE,
        "replaces": UNION_REPLACES[1], "launches": sum(v1_paths.values()),
        "paths": v1_paths,
        "max_abs_err": max(union_err[1], ivf_sl["max_abs_err"],
                           *(c["max_abs_err"] for c in sharded["ivf"]["bfloat16"][
                               "shard_kernel_cases"])),
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
        "replaces": PQ_REPLACES, "launches": sum(pq_paths.values()), "paths": pq_paths,
        "rows_per_launch": pq_rows,
        "max_abs_err": max(pq_err, shard_k4["max_abs_err"],
                           *(pq_sl[k]["max_abs_err"] for k in ("pq", "ivf_pq"))),
        # at a shard's union of the sharded IVF-PQ, the rows most launches get
        "shape": f"{shard_k4['rows']} x M {shard_k4['M']} {shard_k4['dtype']}",
        "ms": shard_k4["ms"], "device_ms": shard_k4["device_ms"],
        "plain_ms": shard_k4["plain_ms"],
        **achieved({"bytes": shard_k4["bytes"], "flops": 0, "dtype": shard_k4["dtype"]},
                   shard_k4["ms"]),
        "library_ms": shard_k4["library_ms"],
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
    if any(e["launches"] <= 0 for e in kernels) or min(flat_paths.values()) <= 0 or \
            min(v1_paths.values()) <= 0 or min(pq_paths.values()) <= 0:
        raise AssertionError("a kernel was not launched on its path")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
