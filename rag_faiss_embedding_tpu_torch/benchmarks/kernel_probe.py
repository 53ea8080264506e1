"""Kernel-stage probe of the IVF union scan, on the card.

Counterpart of ``benchmarks/pallas_kernel_probe.py``: the union scan's
scoring and binned selection on identical synthetic blocks (no index build;
``u_all`` is a seeded random permutation; the shapes are the 1M
production configuration's), with the selection swapped four ways
(``ops/kernel_probe``, K6, ``csrc/kernel_probe.cu``):

  none       scores + packing, no selection (writes the last packed tile)
  chain      the committed kernel's chain: bins read, changed, written back
             per block
  temps      the chain in registers, the bins touched once per cell
  temps_f32  temps with the chain on float32 max/min of the packed bits

Run on one card (``python -m
rag_faiss_embedding_tpu_torch.benchmarks.kernel_probe``). It prints one JSON
line per variant, ``{"variant": ..., "ms_per_batch": ...}`` (CUDA events
over REPS calls after a warm-up, best of three), with the card's name and
power limit. A variant that fails raises.
"""

from __future__ import annotations

import json

import torch

from ..ops.kernel_probe import VARIANTS, probe
from .fused_proto import card

NLIST, WINDOW, DIM = 8192, 256, 384
QC, U, BB, CAP = 256, 260, 10, 2
CHUNKS, REPS = 4, 8
SEED = 0


def make_inputs(*, device, seed: int = SEED, nlist: int = NLIST, window: int = WINDOW,
                dim: int = DIM, qc: int = QC, u: int = U, chunks: int = CHUNKS) -> dict:
    """The script's synthetic blocks, made on ``device`` from a seeded
    generator: ``codes3`` N(0, 1) bf16 (nlist+1, window, dim); ``aux3``
    (nlist+1, 2, window) int32 with the float32 bits of |N(0, 1)| * 300 + 100
    as norms and ids 1; ``qs`` N(0, 1) bf16 (chunks, qc, dim); ``u_all`` the
    first ``u`` of a seeded permutation of the lists per chunk, sorted."""
    g = torch.Generator(device=device).manual_seed(seed)
    codes3 = torch.randn((nlist + 1, window, dim), generator=g, device=device,
                         dtype=torch.bfloat16)
    norms = torch.randn((nlist + 1, 1, window), generator=g, device=device).abs() * 300 + 100
    aux3 = torch.cat([norms.view(torch.int32),
                      torch.ones((nlist + 1, 1, window), dtype=torch.int32, device=device)], 1)
    qs = torch.randn((chunks, qc, dim), generator=g, device=device, dtype=torch.bfloat16)
    u_all = torch.stack([torch.randperm(nlist, generator=g, device=device)[:u]
                         for _ in range(chunks)]).to(torch.int32)
    return {"u_all": torch.sort(u_all, dim=1).values, "qs": qs, "codes3": codes3,
            "aux3": aux3}


def time_variant(variant: str, inputs: dict, *, bb: int = BB, cap: int = CAP,
                 reps: int = REPS) -> float:
    """Best of three CUDA-event runs of ``reps`` calls, in ms per call."""
    probe(variant, **inputs, bb=bb, cap=cap)  # warm-up
    best = None
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            probe(variant, **inputs, bb=bb, cap=cap)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        best = ms if best is None else min(best, ms)
    return best


def run(inputs: dict, *, bb: int = BB, cap: int = CAP) -> list:
    """Every variant timed on the same inputs: one dict per variant."""
    return [{"variant": v, "ms_per_batch": time_variant(v, inputs, bb=bb, cap=cap)}
            for v in VARIANTS]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device; this benchmark runs on a GPU")
    smi = card()
    inputs = make_inputs(device=torch.device("cuda"))
    for row in run(inputs):
        print(json.dumps({**row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
