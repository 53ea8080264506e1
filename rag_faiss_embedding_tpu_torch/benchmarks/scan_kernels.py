"""Time the scan kernels K1 (flat scan), K2 / K3 (IVF union scan), K4 (the
PQ decode), K5 (the prototype's cell top-k) and K6 (the union-scan stage
probe) at their headline shapes on one card, beside K1's plain version.

Run from the repository root, with one CUDA card visible:

    python3 rag_faiss_embedding_tpu_torch/benchmarks/scan_kernels.py [--root DIR] [--waves]
        [--kernels pq_decode ...]

``--root DIR`` imports ``rag_faiss_embedding_tpu_torch`` from DIR, another
checkout of the repository (a ``git archive`` of an earlier commit), so two
versions of the kernels can be timed on one card in one run: run it once
per root, in turns (a b b a). The data and the helpers that cut a search
into its kernel call are ``chip_smoke.py``'s, from this checkout.

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
as chip_smoke's ``cuda_ms`` takes it (host work included), the kernel's
device time (``torch.profiler``), the wrapper's host time (the host clock
over back-to-back calls, no synchronize), the bytes bound, and
``F.embedding`` on the same inputs (per call and device).
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
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
KERNELS = ("flat_scan", "union_scan", "fused_proto", "kernel_probe", "pq_decode")
# K4's rows per launch on its paths (chip_smoke's ``rows_per_launch``): the
# PQ slice's 4,096; a shard's union of the sharded IVF-PQ, 16,384 and
# 32,768; union segments of the 10M chunked IVF-PQ, 180,224 and 360,448;
# flat PQ's 524,288-row chunks; and 1M
K4_ROWS = {"slice": 4096, "shard union": 16384, "shard union x2": 32768,
           "short chunked segment": 180224, "chunked segment": 360448,
           "flat chunk": 1 << 19, "1M": 1 << 20}


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
                "rows": n, "ms": C.cuda_ms(torch, lambda: PD.decode(cb, codes), reps),
                "device_ms": C.device_ms(torch, lambda: PD.decode(cb, codes)),
                "host_us": C.host_us(torch, lambda: PD.decode(cb, codes),
                                     1000 if n <= 65536 else 200),
                "bound_ms": C.bound(nbytes, 0, "bfloat16")[0],
                "library_ms": C.cuda_ms(torch, lambda: Fn.embedding(flat, table), reps),
                "library_device_ms": C.device_ms(torch, lambda: Fn.embedding(flat, table)),
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
                        C.device_ms(torch, lambda: PD.decode(cb, codes)))
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
        k1[f"1M Q={nq}"] = C.cuda_ms(torch, lambda: F.flat_search(q, big, 10, db_sq=big_sq))
    k1["1M Q=1024 plain"] = C.cuda_ms(
        torch, lambda: F.flat_search_reference(q, big, 10, db_sq=big_sq), 5, 1)
    small, q1 = big[:4096].contiguous(), big[:1].clone()
    small_sq = sqnorms(small)
    k1["slice Q=1"] = C.cuda_ms(torch, lambda: F.flat_search(q1, small, 5, db_sq=small_sq))
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
        k1[name] = C.cuda_ms(torch, lambda: F.flat_search(qq, big, k, db_sq=big_sq, **kw))
    for k, reps in ((100, 5), (1000, 3)):
        k1[f"1M Q=1 k={k} plain"] = C.cuda_ms(
            torch, lambda: F.flat_search_reference(qk, big, k, db_sq=big_sq), reps, 1)
    if waves:
        chosen = F._TILED_WAVES
        for w in (1, 2, 4):
            F._TILED_WAVES = w
            k1[f"1M Q=1024 tiled, {w} waves"] = C.cuda_ms(
                torch, lambda: F.flat_search(q, big, 10, db_sq=big_sq, path="tiled"))
        F._TILED_WAVES = chosen
    del big, big_sq
    torch.cuda.empty_cache()
    return k1


def ivf_kernel_times(torch, C, S, U, kernels) -> dict:
    """K2 / K3, K5 and K6 (those of them in ``kernels``) over chip_smoke's 1M
    bf16 IVF build and the probe's inputs."""
    out = {}
    idx, build_s, queries, _ = C.ivf_build(torch)
    if "union_scan" in kernels:
        k2 = {"build_s": build_s}
        for variant in (1, 2):
            call, disp = C.union_args(S, idx, queries, 10, variant)
            k2[f"v{variant} Q=1024"] = C.cuda_ms(torch, lambda: U.union_scan(**call))
        k2["nprobe"] = disp["nprobe"]
        idx.backend, idx.pallas_variant = "auto", 1
        k2["search Q=1024"] = C.cuda_ms(torch, lambda: idx.search(queries, 10))
        out["union_scan"] = k2

    from rag_faiss_embedding_tpu_torch.benchmarks import fused_proto as BF
    from rag_faiss_embedding_tpu_torch.benchmarks import kernel_probe as BK
    from rag_faiss_embedding_tpu_torch.ops import fused_proto as FP
    from rag_faiss_embedding_tpu_torch.ops import kernel_probe as KP

    if "fused_proto" in kernels:
        _, _, cells = BF.cell_args(queries, idx)
        out["fused_proto"] = {f"Q=1024 kp={kp}": C.cuda_ms(
            torch, lambda: FP.block_topk(**cells, kp=kp)) for kp in (BF.KP, 1, FP.KP_MAX)}
        out["fused_proto"]["search Q=1024"] = C.cuda_ms(torch, lambda: BF.search(queries, idx))
        del cells
    del idx
    torch.cuda.empty_cache()
    if "kernel_probe" in kernels:
        inputs = BK.make_inputs(device=torch.device("cuda"), seed=C.SEED)
        out["kernel_probe"] = {v: C.cuda_ms(torch, lambda: KP.probe(v, **inputs, bb=BK.BB,
                                                                    cap=BK.CAP))
                               for v in KP.VARIANTS}
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
    if "flat_scan" in args.kernels:
        out["flat_scan"] = flat_scan_times(torch, C, F, sqnorms, args.waves)
    if {"union_scan", "fused_proto", "kernel_probe"} & set(args.kernels):
        out.update(ivf_kernel_times(torch, C, S, U, args.kernels))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
