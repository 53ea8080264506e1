"""Per-stage latency timers.

A copy of ``rag_faiss_embedding_tpu/utils/timers.py`` (the reference has no
tracing at all, SURVEY.md §5). Used by the pipeline CLI and the API
server; pairs with ``utils.profiling`` for device traces."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List


class StageTimer:
    def __init__(self):
        self.stages: Dict[str, List[float]] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self.stages.items():
            s = sorted(times)
            out[name] = {
                "count": len(s),
                "total_s": sum(s),
                "mean_s": sum(s) / len(s),
                "p50_s": s[len(s) // 2],
                "p99_s": s[min(len(s) - 1, int(len(s) * 0.99))],
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'mean ms':>12}{'p50 ms':>12}{'p99 ms':>12}"]
        for name, st in self.summary().items():
            lines.append(
                f"{name:<24}{st['count']:>8}{st['mean_s']*1e3:>12.2f}"
                f"{st['p50_s']*1e3:>12.2f}{st['p99_s']*1e3:>12.2f}"
            )
        return "\n".join(lines)
