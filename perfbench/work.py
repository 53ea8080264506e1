"""The yardstick's work counts: operations and bytes from shapes, and the
card's peaks.

Frozen copies of ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` / ``PEAK_FLOPS``
(``chip_smoke.py:248-249``), ``flat_work`` (``:893``), ``bound``
(``:3289``) and ``work_bound`` (``:3572``); ``ivf_work`` follows
``scan_work`` (``:865``) with each probed row read once per call. The
encoder's count is new. Nothing here reads the program.
"""

from __future__ import annotations

# H100 SXM, dense, as published: HBM bytes per second, and operations per
# second of the unit an exact result needs (FP32 outside the tensor cores
# for float32, bf16 tensor cores with float32 accumulation for bf16)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

# kernel names (substrings of the profiler's names) of each hand kernel
KERNELS = {
    "k1": ("scan_partial", "scan_tiled", "merge_partials"),  # csrc/flat_scan.cu
    "k2": ("scan_bins", "merge_bins"),  # csrc/union_scan.cu
}


def flat_work(q: int, n: int, d: int, k: int) -> dict:
    """The exact float32 flat scan of ``q`` queries over ``n`` rows of ``d``:
    rows, norms and queries read once, (value, id) of the top ``k`` written;
    a multiply and an add per query, row and dimension."""
    return {"bytes": n * (d + 1) * 4 + q * d * 4 + q * k * 8, "flops": 2 * q * n * d,
            "dtype": "float32"}


def ivf_work(q: int, d: int, k: int, probed_rows: int, union_rows: int,
             dtype: str = "bfloat16") -> dict:
    """An IVF list scan: ``probed_rows`` (query, live row) pairs over all
    queries, each distinct probed row (``union_rows``) read once with its
    norm and id, the queries read and (value, id) of the top ``k`` written."""
    item = 2 if dtype == "bfloat16" else 4
    return {"bytes": union_rows * (d * item + 8) + q * d * item + q * k * 8,
            "flops": 2 * probed_rows * d, "dtype": dtype}


def bound(bytes_moved: float, flops: float, dtype: str):
    """The least time the card could take for the work, in seconds, and what
    bounds it: bytes over HBM_BYTES_PER_S or operations over the peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def work_bound(work: dict) -> float:
    return bound(work["bytes"], work["flops"], work["dtype"])[0]


def encoder_flops(lengths, cfg: dict) -> float:
    """MiniLM's operations over sequences of ``lengths`` real tokens: per
    token and layer 2 x (4 h^2 + 2 h f) for the dense products (2 x
    1,769,472 at h 384, f 1,536) and 4 L h for attention's two products at
    the sequence's own length L. Padding is not counted."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    dense = 2 * (4 * h * h + 2 * h * f)
    return float(sum(n * ln * (dense + 4 * ln * h) for ln in lengths))
