"""Device profiling hooks on ``torch.profiler``.

Counterpart of ``rag_faiss_embedding_tpu/utils/profiling.py``, which wraps
``jax.profiler.start_trace`` / ``TraceAnnotation``. Here the trace is a
``torch.profiler.profile`` over the host and, where a card is visible, the
CUDA device, exported as a Chrome trace (open it in Perfetto or
``chrome://tracing``). The reference has no tracing or profiling at all
(SURVEY.md §5); this pairs the host-side ``StageTimer`` with device traces.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

import torch

from ..core.logging import get_logger

logger = get_logger(__name__)


@contextmanager
def device_trace(log_dir: str | Path = "logs/torch_trace") -> Iterator[None]:
    """Trace the enclosed block (host ops, and CUDA kernels where a card is
    visible) into ``<log_dir>/trace-<time>.json``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        out = log_dir / f"trace-{time.time_ns()}.json"
        prof.export_chrome_trace(str(out))
        logger.info("device trace written to %s", out)


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace."""
    with torch.profiler.record_function(name):
        yield
