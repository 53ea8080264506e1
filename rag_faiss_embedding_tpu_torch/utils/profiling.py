"""Device profiling hooks on ``torch.profiler``.

Counterpart of ``rag_faiss_embedding_tpu/utils/profiling.py``, which wraps
``jax.profiler.start_trace`` / ``TraceAnnotation``. Here the trace is a
``torch.profiler.profile`` over the host and, where a card is visible, the
CUDA device, exported as a Chrome trace (open it in Perfetto or
``chrome://tracing``). The reference has no tracing or profiling at all
(SURVEY.md §5); this pairs the host-side ``StageTimer`` with device traces.
While the trace records, so do the port's spans (``utils.timers.span``):
they are written beside it as ``spans-<time>.json``.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

import torch

from ..core.logging import get_logger
from . import timers

logger = get_logger(__name__)


@contextmanager
def device_trace(log_dir: str | Path = "logs/torch_trace") -> Iterator[None]:
    """Trace the enclosed block (host ops, and CUDA kernels where a card is
    visible) into ``<log_dir>/trace-<time>.json``, and the port's spans
    that started in it into ``<log_dir>/spans-<time>.json`` (a list of
    ``utils.timers.spans`` records, times on ``time.monotonic_ns``)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        prof.stop()
        t1 = time.monotonic_ns()
        stamp = time.time_ns()
        out = log_dir / f"trace-{stamp}.json"
        prof.export_chrome_trace(str(out))
        (log_dir / f"spans-{stamp}.json").write_text(json.dumps(timers.spans(t0, t1)))
        logger.info("device trace written to %s", out)


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace."""
    with torch.profiler.record_function(name):
        yield
