"""The port's spans and the card's kernels on one clock (card only).

``perfbench.tracing.DeviceTrace`` maps the profiler's device events onto
``time.monotonic_ns``, the clock of ``utils.timers`` spans. Inside its
window (a profiler of CUDA activity only) the spans must record, and a
flat search's K1 launches must lie between the opening of its
``index.search`` span and the close of its ``vector_store.to_host`` span,
where the host waits for the card. Runs on the card with
``python -m pytest tests/test_torch_tracing_card.py -m cuda --noconftest -q``.
"""

import numpy as np
import pytest
import torch
from torch.autograd import _profiler_enabled

from perfbench import work
from perfbench.tracing import DeviceTrace
from rag_faiss_embedding_tpu_torch.index import VectorStore
from rag_faiss_embedding_tpu_torch.utils import timers

N, D, K = 262_144, 384, 10


@pytest.fixture
def store(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    s = VectorStore(D, index_path=tmp_path / "idx", device="cuda")
    rows = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    s.add_vectors(rows, list(range(1, N + 1)))
    s.search(rows[:1], K)  # builds and warms K1
    torch.cuda.synchronize()
    return s, rows


@pytest.mark.cuda
def test_k1_lies_inside_its_search_spans(store):
    s, rows = store
    for _ in range(3):  # the profiler now and then drops device events
        timers.clear()
        dev = DeviceTrace(True)
        with dev.window():
            profiling = _profiler_enabled()
            s.search(rows[7], K)
        k1 = [(a, b) for name, card, a, b in dev.events
              if card == 0 and any(k in name for k in work.KERNELS["k1"])]
        if k1:
            break
    assert profiling, "spans do not record under a CUDA-only profiler"
    by = {r["name"]: r for r in timers.spans()}
    timers.clear()
    assert k1, "no K1 event in three traces"
    search, wait = by["index.search"], by["vector_store.to_host"]
    assert search["t0_ns"] <= min(a for a, _ in k1)
    assert max(b for _, b in k1) <= wait["t1_ns"]
