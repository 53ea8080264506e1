"""Time the scan kernels K1 (flat scan), K2 / K3 (IVF union scan), K4 (the
PQ decode), K5 (the prototype's cell top-k) and K6 (the union-scan stage
probe) at their headline shapes on one card, beside K1's plain version, the
answer generator's prefill attention (``ops/mla_attention``) and Kimi-Linear's
KDA state pass (``ops/kda``).

Run from the repository root, with one CUDA card visible:

    python3 rag_faiss_embedding_tpu_torch/benchmarks/scan_kernels.py [--root DIR] [--waves]
        [--kernels pq_decode attention kda ...]

``--root DIR`` imports ``rag_faiss_embedding_tpu_torch`` from DIR, another
checkout of the repository (a ``git archive`` of an earlier commit), so two
versions of the kernels can be timed on one card in one run: run it once
per root, in turns (a b b a). It loads this checkout's ``chip_smoke.py`` by
its path, whatever ``--root`` holds, for three names only: ``SEED``,
``ivf_build`` (the 1M IVF data and build) and ``union_args`` (a search cut
to its union-scan call), so that both checkouts' kernels are timed on the
same rows. The timers are this file's own.

Shapes: K1 over 1,048,576 x 384 float32 rows (chip_smoke's kernel phase) at
Q = 1 and 1,024, k = 10, with row norms precomputed as the index keeps them,
and at the flat slice's shape (4,096 rows, Q = 1, k = 5); K1 at Q = 1
with k 100 and 1,000, and with 30% of the rows dead at Q = 1 and 1,024
(None where the timed checkout refuses them); K1's plain version at Q =
1,024 and at Q = 1 with k 100 and 1,000; K2 (union-scan variant 1) and K3 (variant 2) over
bench.py's 1M x 384 bf16 IVF index (chip_smoke's ``ivf_build``) at Q =
1,024 and the index's default nprobe, and ``IVFFlatIndex.search`` there;
K5 at the prototype's shape over the same index (``benchmarks.fused_proto``:
Q = 1,024, UCAP = QC = 256, BB 16, KP 10, and kp 1 and 32, which change
only the selection's work) and the prototype search; K6 at the probe's shape
(``benchmarks.kernel_probe.make_inputs``: U 260, BB 10, CAP 2, 4 chunks of
256 queries), each variant. K4 at the rows its paths launch it on
(``K4_ROWS``), M 48, ksub 256, dsub 8, in bf16 and f32: the per-call time
as ``cuda_ms`` takes it (host work included), the kernel's device time
(``device_ms``), the wrapper's host time (``host_us``), the bytes bound at
the card's HBM rate, and ``F.embedding`` on the same inputs (per call and
device). ``build_s`` is ``ivf_build``'s wall time: the rows, the build and
their exact top-10.
The prefill attention (``attention``) at one layer of the answer cell's
prefill (``ATTN_N`` rows, DeepSeek-V2-Lite's 16 heads, q / k 192, v 128,
operands laid out as ``DeepseekV2._attend_prefill`` has them): the kernel's
per-call and device time, its bound (the causal attention's FLOPs at bf16's
989 TFLOP/s), its plain version, and as ``library_device_ms`` the
device time of PyTorch's FlashAttention-2 over v padded to 192 (what the
port called before). It needs a checkout that has the kernel.
The KDA state pass (``kda``) at one KDA layer of the Kimi answer cell's
prefill (``ATTN_N`` rows in chunks of 64, 32 heads of 128, operands made by
``ops/kda.chunk_operands`` from inputs drawn as a KDA layer makes them):
the kernel's per-call and device time (held to its twin first), its bound
(the larger of its bytes at the HBM rate and its three products a chunk
at bf16's rate), and its plain twin's time; then one layer's decode step,
the kernel's and its twin's time (``decode_ms``, ``decode_plain_ms``). It
needs a checkout that has the kernels.
``--k4-crossover`` (this checkout's kernels only) also times K4 with its
codebook gathered through L2 and staged in shared memory, in turns, at N
either side of the staged band (``K4_CROSSOVER_ROWS``): the measurements
that place ``pq_decode.STAGED_MIN_ROWS`` and ``STAGED_MAX_BYTES``.
``--kernels`` times only the named ones. ``--waves`` (this checkout's kernels only) also times K1's tiled path at Q =
1,024 over the 1M rows with its database splits planned for 1, 2 and 4
waves of the blocks the card holds at once. Prints one JSON object:
CUDA-event medians in ms, with the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
KERNELS = ("flat_scan", "union_scan", "fused_proto", "kernel_probe", "pq_decode", "attention",
           "kda")
# The card's published HBM rate (H100 SXM): K4's bound is its bytes over it
HBM_BYTES_PER_S = 3.35e12
# and its dense bf16 tensor-core rate: the prefill attention's bound
BF16_FLOPS = 989e12
# the answer cell's prompt rows: one prefill's attention a layer
ATTN_N = 16896
# K4's rows per launch on its paths (chip_smoke's ``PQ_PATH_ROWS``): the PQ
# slice's 4,096; a shard's union of the sharded IVF-PQ, 16,384 and 32,768;
# union segments of the 10M chunked IVF-PQ, 180,224 and 360,448; flat PQ's
# 524,288-row chunks; and 1M
K4_ROWS = {"slice": 4096, "shard union": 16384, "shard union x2": 32768,
           "short chunked segment": 180224, "chunked segment": 360448,
           "flat chunk": 1 << 19, "1M": 1 << 20}


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


def pq_decode_times(torch, C, PD) -> dict:
    """K4 and ``F.embedding`` at ``K4_ROWS`` x M 48 (ksub 256, dsub 8), bf16
    and f32 codebooks; every kernel output held to ``decode_reference`` by
    raw bits."""
    import torch.nn.functional as Fn

    g = torch.Generator(device="cuda").manual_seed(C.SEED)
    m, ksub, dsub = 48, 256, 8
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cb = torch.randn((m, ksub, dsub), generator=g, device="cuda").to(dtype)
        table = cb.reshape(m * ksub, dsub)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for name, n in K4_ROWS.items():
            codes = torch.randint(0, ksub, (n, m), generator=g, device="cuda").to(torch.uint8)
            flat = codes.long() + torch.arange(m, device="cuda") * ksub
            got = PD.decode(cb, codes)
            if not torch.equal(got.view(bits), PD.decode_reference(cb, codes).view(bits)):
                raise AssertionError(f"pq_decode differs from its plain version at {n} rows")
            del got
            nbytes = n * m + n * m * dsub * cb.element_size() + cb.numel() * cb.element_size()
            try:
                plan = PD.plan(m, ksub, dsub, dtype, n=n)
            except TypeError:  # a checkout whose plan takes no N
                plan = PD.plan(m, ksub, dsub, dtype)
            reps = 50 if n <= 65536 else 10  # the host's noise weighs most at small N
            out[f"{name} {n} {str(dtype).removeprefix('torch.')}"] = {
                "rows": n, "ms": cuda_ms(torch, lambda: PD.decode(cb, codes), reps),
                "device_ms": device_ms(torch, lambda: PD.decode(cb, codes)),
                "host_us": host_us(torch, lambda: PD.decode(cb, codes),
                                   1000 if n <= 65536 else 200),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "library_ms": cuda_ms(torch, lambda: Fn.embedding(flat, table), reps),
                "library_device_ms": device_ms(torch, lambda: Fn.embedding(flat, table)),
                "plan": plan}
            del codes, flat
        torch.cuda.empty_cache()
    return out


# N on both sides of K4's staged band (ops/pq_decode.STAGED_MIN_ROWS,
# STAGED_MAX_BYTES)
K4_CROSSOVER_ROWS = (4096, 5120, 6144, 8192, 12288, 16384, 20480, 24576, 32768, 40960,
                     49152, 65536)


def pq_decode_crossover(torch, C, PD) -> dict:
    """K4's device time at ``K4_CROSSOVER_ROWS`` x M 48 (ksub 256, dsub 8),
    bf16 and f32, with the codebook gathered through L2 and staged in shared
    memory (the plan forced each way), in turns: the measurements that place
    the staged band's ends."""
    g = torch.Generator(device="cuda").manual_seed(C.SEED)
    m, ksub, dsub = 48, 256, 8
    chosen = (PD.STAGED_MIN_ROWS, PD.STAGED_MAX_BYTES)
    ways = {"l2": (1 << 62, 0), "staged": (0, 1 << 62)}
    out = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            cb = torch.randn((m, ksub, dsub), generator=g, device="cuda").to(dtype)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            for n in K4_CROSSOVER_ROWS:
                codes = torch.randint(0, ksub, (n, m), generator=g,
                                      device="cuda").to(torch.uint8)
                ref = PD.decode_reference(cb, codes).view(bits)
                row = {}
                for way in ("l2", "staged", "staged", "l2"):
                    PD.STAGED_MIN_ROWS, PD.STAGED_MAX_BYTES = ways[way]
                    PD._plan_fields.cache_clear()
                    if not torch.equal(PD.decode(cb, codes).view(bits), ref):
                        raise AssertionError(f"pq_decode ({way}) differs at {n} rows")
                    row.setdefault(way, []).append(
                        device_ms(torch, lambda: PD.decode(cb, codes)))
                PD.STAGED_MIN_ROWS, PD.STAGED_MAX_BYTES = chosen
                row["chosen"] = "staged" if PD.plan(m, ksub, dsub, dtype, n)["staged"] else "l2"
                out[f"{n} {str(dtype).removeprefix('torch.')}"] = row
    finally:
        PD.STAGED_MIN_ROWS, PD.STAGED_MAX_BYTES = chosen
        PD._plan_fields.cache_clear()
    return out


def flat_scan_times(torch, C, F, sqnorms, waves: bool) -> dict:
    """K1 at its headline shapes, and its plain version."""
    g = torch.Generator(device="cuda").manual_seed(C.SEED)
    big = torch.randn(1 << 20, 384, generator=g, device="cuda")
    big_sq = sqnorms(big)
    k1 = {}
    for nq in (1, 1024):
        q = torch.randn(nq, 384, generator=g, device="cuda")
        k1[f"1M Q={nq}"] = cuda_ms(torch, lambda: F.flat_search(q, big, 10, db_sq=big_sq))
    k1["1M Q=1024 plain"] = cuda_ms(
        torch, lambda: F.flat_search_reference(q, big, 10, db_sq=big_sq), 5, 1)
    small, q1 = big[:4096].contiguous(), big[:1].clone()
    small_sq = sqnorms(small)
    k1["slice Q=1"] = cuda_ms(torch, lambda: F.flat_search(q1, small, 5, db_sq=small_sq))
    # k above KMAX and a mask of dead rows (30%); None where the timed
    # checkout refuses them
    dead = torch.rand(1 << 20, generator=g, device="cuda") < 0.3
    qk = torch.randn(1, 384, generator=g, device="cuda")
    for name, qq, k, kw in (("1M Q=1 k=100", qk, 100, {}), ("1M Q=1 k=1000", qk, 1000, {}),
                            ("1M Q=1 dead", qk, 10, {"dead": dead}),
                            ("1M Q=1024 dead", q, 10, {"dead": dead})):
        try:
            F.flat_search(qq, big, k, db_sq=big_sq, **kw)
        except (ValueError, TypeError):
            k1[name] = None
            continue
        k1[name] = cuda_ms(torch, lambda: F.flat_search(qq, big, k, db_sq=big_sq, **kw))
    for k, reps in ((100, 5), (1000, 3)):
        k1[f"1M Q=1 k={k} plain"] = cuda_ms(
            torch, lambda: F.flat_search_reference(qk, big, k, db_sq=big_sq), reps, 1)
    if waves:
        chosen = F._TILED_WAVES
        for w in (1, 2, 4):
            F._TILED_WAVES = w
            k1[f"1M Q=1024 tiled, {w} waves"] = cuda_ms(
                torch, lambda: F.flat_search(q, big, 10, db_sq=big_sq, path="tiled"))
        F._TILED_WAVES = chosen
    del big, big_sq
    torch.cuda.empty_cache()
    return k1


def ivf_kernel_times(torch, C, S, U, kernels) -> dict:
    """K2 / K3, K5 and K6 (those of them in ``kernels``) over chip_smoke's 1M
    bf16 IVF build and the probe's inputs."""
    out = {}
    t0 = time.perf_counter()
    idx, queries, _ = C.ivf_build(torch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if "union_scan" in kernels:
        k2 = {"build_s": build_s}
        for variant in (1, 2):
            call, disp = C.union_args(S, idx, queries, 10, variant)
            k2[f"v{variant} Q=1024"] = cuda_ms(torch, lambda: U.union_scan(**call))
        k2["nprobe"] = disp["nprobe"]
        idx.backend, idx.pallas_variant = "auto", 1
        k2["search Q=1024"] = cuda_ms(torch, lambda: idx.search(queries, 10))
        out["union_scan"] = k2

    from rag_faiss_embedding_tpu_torch.benchmarks import fused_proto as BF
    from rag_faiss_embedding_tpu_torch.benchmarks import kernel_probe as BK
    from rag_faiss_embedding_tpu_torch.ops import fused_proto as FP
    from rag_faiss_embedding_tpu_torch.ops import kernel_probe as KP

    if "fused_proto" in kernels:
        _, _, cells = BF.cell_args(queries, idx)
        out["fused_proto"] = {f"Q=1024 kp={kp}": cuda_ms(
            torch, lambda: FP.block_topk(**cells, kp=kp)) for kp in (BF.KP, 1, FP.KP_MAX)}
        out["fused_proto"]["search Q=1024"] = cuda_ms(torch, lambda: BF.search(queries, idx))
        del cells
    del idx
    torch.cuda.empty_cache()
    if "kernel_probe" in kernels:
        inputs = BK.make_inputs(device=torch.device("cuda"), seed=C.SEED)
        out["kernel_probe"] = {v: cuda_ms(torch, lambda: KP.probe(v, **inputs, bb=BK.BB,
                                                                    cap=BK.CAP))
                               for v in KP.VARIANTS}
    return out


def attention_times(torch, C) -> dict:
    """One prefill layer's causal attention at ``ATTN_N`` rows x 16 heads:
    the kernel (held to its plain version first), its plain version, and
    FlashAttention-2 over v padded to 192."""
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from rag_faiss_embedding_tpu_torch.models.deepseek_v2 import DeepseekV2Config
    from rag_faiss_embedding_tpu_torch.ops import mla_attention as A

    cfg = DeepseekV2Config()
    n, heads, rank = ATTN_N, cfg.num_attention_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    g = torch.Generator(device="cuda").manual_seed(C.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    qa = randn(n, heads * (nope + rope) + cfg.cache_width)
    q_nope = qa[:, : heads * nope].view(n, heads, nope)
    q_pe, rows, kv = randn(n, heads, rope), randn(n, cfg.cache_width), randn(n, heads, nope + dv)
    k_nope, v = kv.split([nope, dv], -1)
    k_pe, scale = rows[:, rank:], cfg.softmax_scale
    flops = 2 * heads * n * (n + 1) / 2 * (nope + rope + dv)
    out = {"n": n, "heads": heads, "flops": flops, "bound_ms": flops / BF16_FLOPS * 1e3}
    ops = (q_nope, q_pe, k_nope, k_pe, v, scale)
    got = A.mla_prefill_attention(*ops).float()
    want = A.mla_prefill_attention_reference(*ops).float()
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    if rel > 1e-2:
        raise AssertionError(f"mla_prefill_attention differs from its plain version: {rel}")
    del got, want
    out["ms"] = cuda_ms(torch, lambda: A.mla_prefill_attention(*ops))
    out["device_ms"] = device_ms(torch, lambda: A.mla_prefill_attention(*ops), 10)
    out["share"] = out["bound_ms"] / out["device_ms"]
    out["plain_ms"] = cuda_ms(torch, lambda: A.mla_prefill_attention_reference(*ops), 3, 1)

    q = torch.cat((q_nope, q_pe), -1).transpose(0, 1)[None]
    k = torch.cat((k_nope, k_pe[:, None].expand(n, heads, rope)), -1).transpose(0, 1)[None]
    vp = Fn.pad(v, (0, nope + rope - dv)).transpose(0, 1)[None]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        out["library_device_ms"] = device_ms(
            torch, lambda: Fn.scaled_dot_product_attention(q, k, vp, is_causal=True,
                                                           scale=scale), 10)
    del q, k, vp
    torch.cuda.empty_cache()
    return out


def kda_times(torch, C) -> dict:
    """One KDA layer's state pass at ``ATTN_N`` rows x 32 heads: the kernel
    (held to its twin first) and the twin."""
    import torch.nn.functional as Fn

    from rag_faiss_embedding_tpu_torch.ops import kda

    n, heads, d = ATTN_N, 32, kda.WIDTH
    g = torch.Generator(device="cuda").manual_seed(C.SEED)
    q = Fn.normalize(torch.randn(n, heads, d, generator=g, device="cuda"), dim=-1) * d ** -0.5
    k = Fn.normalize(torch.randn(n, heads, d, generator=g, device="cuda"), dim=-1)
    v = torch.randn(n, heads, d, generator=g, device="cuda")
    decay = -Fn.softplus(torch.randn(n, heads, d, generator=g, device="cuda") - 4.0)
    beta = torch.rand(n, heads, generator=g, device="cuda")
    ops = kda.chunk_operands(*(kda.to_blocks(x.transpose(0, 1), n) for x in (q, k, v, decay)),
                             kda.to_blocks(beta.t()[..., None], n))
    s0 = torch.zeros(heads, d, d, device="cuda")
    del q, k, v, decay, beta
    chunks = ops[0].shape[1]
    rows = heads * chunks * kda.CHUNK
    bytes_moved = 4 * (6 * rows * d + heads * chunks * d + 2 * heads * d * d)
    flops = 3 * 2 * rows * d * d
    out = {"n": n, "heads": heads, "chunks": chunks, "bytes": bytes_moved, "flops": flops,
           "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3}
    got, last = kda.kda_state_pass(*ops, s0)
    want, want_last = kda.kda_state_pass_reference(*ops, s0)
    err = max(float((got - want).abs().max() / want.abs().max()),
              float((last - want_last).abs().max() / want_last.abs().max()))
    if err > 1e-4:
        raise AssertionError(f"kda_state_pass differs from its twin: {err}")
    del got, want, last, want_last
    out["max_err_over_largest"] = err
    out["ms"] = cuda_ms(torch, lambda: kda.kda_state_pass(*ops, s0))
    out["device_ms"] = device_ms(torch, lambda: kda.kda_state_pass(*ops, s0), 10)
    out["share"] = out["bound_ms"] / out["device_ms"]
    out["plain_ms"] = cuda_ms(torch, lambda: kda.kda_state_pass_reference(*ops, s0), 3, 1)
    del ops
    torch.cuda.empty_cache()
    # the decode step of one layer: the kernel's launches, the twin's ~30
    width = 3 * heads * d
    step = [torch.randn(4, width, generator=g, device="cuda").bfloat16(),
            torch.randn(4, width, generator=g, device="cuda") * 0.5,
            -Fn.softplus(torch.randn(heads, d, generator=g, device="cuda") - 3.0),
            torch.randn(1, heads * d, generator=g, device="cuda").bfloat16(),
            torch.randn(1, heads, generator=g, device="cuda").bfloat16(),
            torch.ones(d, device="cuda")]
    state = torch.randn(heads, d, d, generator=g, device="cuda") * 0.1
    out["decode_bytes"] = 4 * 2 * heads * d * d  # the state read and written
    out["decode_ms"] = cuda_ms(torch, lambda: kda.kda_decode_step(*step, state, 1e-5), 50, 5)
    out["decode_plain_ms"] = cuda_ms(
        torch, lambda: kda.kda_decode_step_reference(*step, state, 1e-5), 50, 5)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose rag_faiss_embedding_tpu_torch is timed")
    ap.add_argument("--waves", action="store_true",
                    help="also time K1's tiled path at 1, 2 and 4 waves of splits")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time only these kernels (default: all)")
    ap.add_argument("--k4-crossover", action="store_true",
                    help="also time K4 gathered through L2 and staged, either side of its "
                         "staged band (this checkout's kernels only)")
    args = ap.parse_args()
    sys.path[:0] = [str(args.root.resolve()), str(REPO)]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scan_kernels: no CUDA device; this runs on a GPU")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)  # this checkout's, whatever --root holds
    spec.loader.exec_module(C)
    from rag_faiss_embedding_tpu_torch.ops import flat_scan as F
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
    from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD
    from rag_faiss_embedding_tpu_torch.ops import union_scan as U
    from rag_faiss_embedding_tpu_torch.ops.distance import sqnorms

    import rag_faiss_embedding_tpu_torch as pkg
    if Path(pkg.__file__).resolve().parents[1] != args.root.resolve():
        raise SystemExit(f"scan_kernels: imported {pkg.__file__}, not from {args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = {"root": str(args.root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    if "pq_decode" in args.kernels:
        out["pq_decode"] = pq_decode_times(torch, C, PD)
    if args.k4_crossover:
        out["pq_decode_crossover"] = pq_decode_crossover(torch, C, PD)
    if "attention" in args.kernels:
        out["attention"] = attention_times(torch, C)
    if "kda" in args.kernels:
        out["kda"] = kda_times(torch, C)
    if "flat_scan" in args.kernels:
        out["flat_scan"] = flat_scan_times(torch, C, F, sqnorms, args.waves)
    if {"union_scan", "fused_proto", "kernel_probe"} & set(args.kernels):
        out.update(ivf_kernel_times(torch, C, S, U, args.kernels))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
