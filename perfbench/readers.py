"""What the metric readers (``metrics/<name>.py``) share.

A reader takes the run's context and returns a number, or None where the
run has nothing it can read (the metric is then left out of the line). The
context holds the window (``rec``, ``window_s``, ``setup_s``); in a traced
run also the host spans that started in the window (``spans``), the work of
each search call (``search_work``), the real lengths of every sequence the
tokenizer made (``encoder_lengths``) and the device's trace (``device``).
"""

from __future__ import annotations

import numpy as np

from . import work


def percentile(values, q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else None


def spans(ctx, name: str) -> list:
    return ctx.get("spans", {}).get(name, [])


def mean_ms(ctx, name: str):
    s = spans(ctx, name)
    return sum(b - a for a, b, _ in s) / len(s) / 1e6 if s else None


def ms_per(ctx, name: str, key: str = "rows"):
    """Span time over the rows its calls handled, in ms a row."""
    s = spans(ctx, name)
    rows = sum(m[key] for _, _, m in s)
    return sum(b - a for a, b, _ in s) / rows / 1e6 if rows else None


def kernel_share(ctx, kernel: str):
    """Percent of the least time the card could take for ``kernel``'s
    launches in the window over their device time (the profiler's, summed
    by kernel name)."""
    dev = ctx.get("device")
    if dev is None:
        return None
    names = work.KERNELS[kernel]
    spent = sum(b - a for n, _, a, b in dev["events"] if any(k in n for k in names)) / 1e9
    least = sum(work.work_bound(w) for call in ctx["search_work"] for kind, w in call
                if kind == kernel)
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def idle_share(ctx):
    dev = ctx.get("device")
    if dev is None or not dev["busy_s"]:
        return None
    return 100.0 * (1.0 - sum(dev["busy_s"]) / len(dev["busy_s"]) / ctx["window_s"])


def mfu(ctx):
    """Percent of the cards' peak: every counted operation's FLOPs over the
    peak of its dtype (the encoder on real tokens, in float32; the scans
    and the coarse product with their kernel counts), over the window times
    the number of cards the run uses (a search over four shards counts four
    cards' work against four cards' peak)."""
    if "encoder_lengths" not in ctx or ctx.get("device") is None:
        return None
    cards = len(ctx["device"]["busy_s"])
    least = work.encoder_flops(ctx["encoder_lengths"], ctx["model"]) / work.PEAK_FLOPS[
        ctx["config"]["encoder"]["dtype"]]
    least += sum(w["flops"] / work.PEAK_FLOPS[w["dtype"]]
                 for call in ctx["search_work"] for _, w in call)
    return 100.0 * least / (ctx["window_s"] * cards) if least > 0 else None
