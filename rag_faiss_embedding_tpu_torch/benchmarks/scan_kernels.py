"""Time the scan kernels K1 (flat scan), K2 / K3 (IVF union scan), K5 (the
prototype's cell top-k) and K6 (the union-scan stage probe) at their
headline shapes on one card, beside K1's plain version.

Run from the repository root, with one CUDA card visible:

    python3 rag_faiss_embedding_tpu_torch/benchmarks/scan_kernels.py [--root DIR] [--waves]

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
256 queries), each variant. ``--waves`` (this checkout's kernels only) also times K1's tiled path at Q =
1,024 over the 1M rows with its database splits planned for 1, 2 and 4
waves of the blocks the card holds at once. Prints one JSON object:
CUDA-event medians in ms, with the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose rag_faiss_embedding_tpu_torch is timed")
    ap.add_argument("--waves", action="store_true",
                    help="also time K1's tiled path at 1, 2 and 4 waves of splits")
    args = ap.parse_args()
    sys.path[:0] = [str(args.root.resolve()), str(REPO)]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scan_kernels: no CUDA device; this runs on a GPU")
    import chip_smoke as C
    from rag_faiss_embedding_tpu_torch.ops import flat_scan as F
    from rag_faiss_embedding_tpu_torch.ops import ivf_scan as S
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
    if args.waves:
        chosen = F._TILED_WAVES
        for waves in (1, 2, 4):
            F._TILED_WAVES = waves
            k1[f"1M Q=1024 tiled, {waves} waves"] = C.cuda_ms(
                torch, lambda: F.flat_search(q, big, 10, db_sq=big_sq, path="tiled"))
        F._TILED_WAVES = chosen
    out["flat_scan"] = k1
    del big, big_sq
    torch.cuda.empty_cache()

    idx, build_s, queries, _ = C.ivf_build(torch)
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

    _, _, cells = BF.cell_args(queries, idx)
    out["fused_proto"] = {f"Q=1024 kp={kp}": C.cuda_ms(torch, lambda: FP.block_topk(**cells, kp=kp))
                          for kp in (BF.KP, 1, FP.KP_MAX)}
    out["fused_proto"]["search Q=1024"] = C.cuda_ms(torch, lambda: BF.search(queries, idx))
    del idx, cells
    torch.cuda.empty_cache()
    inputs = BK.make_inputs(device=torch.device("cuda"), seed=C.SEED)
    out["kernel_probe"] = {v: C.cuda_ms(torch, lambda: KP.probe(v, **inputs, bb=BK.BB,
                                                                cap=BK.CAP))
                           for v in KP.VARIANTS}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
