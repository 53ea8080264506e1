"""The reader of ``index.k1_start_spread_ms_per_search.latency``: how far
apart the cards start their first K1 in each sharded search, on hand-made
records and device events, on an untraced run, on a window with dropped
spans and on a program without the recorder."""

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench.registry import Registry
from perfbench.tests.conftest import ROOT
from rag_faiss_embedding_tpu_torch.utils import timers

NAME = "index.k1_start_spread_ms_per_search.latency"
MS = 1_000_000


def _rec(sid, name, t0, t1, parent=None):
    return {"name": name, "t0_ns": t0, "t1_ns": t1, "id": sid, "parent": parent,
            "request": None, "counts": {}}


@pytest.fixture
def recorded(monkeypatch):
    """Hand the reader ``records`` in place of the port's recorder; the
    window is [0, 100 ms)."""
    state = {"records": [], "dropped": 0}
    monkeypatch.setattr(timers, "spans", lambda t0, t1: [
        r for r in state["records"] if t0 <= r["t0_ns"] < t1])
    monkeypatch.setattr(timers, "dropped", lambda: state["dropped"])
    return state


def _read(device=None):
    ctx = {"rec": {"t0": 0, "t1": 100 * MS}, "window_s": 0.1}
    if device is not None:
        ctx["device"] = device
    return Registry(ROOT).reader(NAME).read(ctx)


def test_k1_start_spread_reads_the_stagger_of_each_search(recorded):
    """Search 1: cards 0-3 start their first K1 at 0.1, 0.4, 0.7 and 1.0 ms
    (stage 2, a later stage 1 on card 0 and the span nested in the root
    count for nothing): 0.9 ms. Search 2: cards 0-1 together, card 1 again
    1 ms later: 0. Search 3 scans one card and is left out. The mean: 0.45
    ms."""
    recorded["records"] = [
        _rec(1, "vector_store.search", 0, 10 * MS),
        _rec(2, "index.search", 0, 9 * MS, 1),
        _rec(3, "vector_store.search", 20 * MS, 30 * MS),
        _rec(4, "vector_store.search", 40 * MS, 50 * MS),
    ]
    events = [("void_merge_partials<float>", 0, MS // 20, MS // 10),
              *[(f"void_scan_partial<float, true>(int {c})", c, (100 + 300 * c) * 1000,
                 3 * MS) for c in range(4)],
              ("void_scan_partial<float, true>", 0, 2 * MS, 3 * MS),
              ("void_scan_tiled<float>", 0, 21 * MS, 23 * MS),
              ("void_scan_tiled<float>", 1, 21 * MS, 23 * MS),
              ("void_scan_tiled<float>", 1, 22 * MS, 23 * MS),
              ("Memcpy PtoP (Device -> Device)", 2, 20 * MS, 21 * MS),
              ("void_scan_partial<float, true>", 2, 41 * MS, 43 * MS)]
    device = {"events": events, "busy_s": [0.01] * 4}
    assert _read(device) == pytest.approx(0.45)
    assert _read() is None  # no device trace
    recorded["records"] = recorded["records"][2:]
    assert _read(device) == pytest.approx(0.0)
    recorded["records"] = recorded["records"][1:]
    assert _read(device) is None  # no search ran K1 on two cards


def test_k1_start_spread_is_silent_without_spans(recorded, monkeypatch):
    device = {"events": [("scan_partial", 0, 0, MS), ("scan_partial", 1, MS, 2 * MS)],
              "busy_s": [0.001, 0.001]}
    assert _read(device) is None  # nothing recorded: an untraced run
    recorded["records"] = [_rec(1, "vector_store.search", 0, 3 * MS)]
    assert _read(device) == pytest.approx(1.0)
    recorded["dropped"] = 1
    assert _read(device) is None  # part of the window is missing
    monkeypatch.delattr(timers, "spans")
    assert _read(device) is None  # a program without the recorder


def test_k1_start_spread_has_a_reader_and_an_entry():
    reg = Registry(ROOT)
    entry = next(m for m in reg.bench["per_layer"] if m["name"] == NAME)
    assert entry["unit"] == reg.reader(NAME).UNIT == "ms"
    assert entry["source"] == "device_trace" and entry["moves"] == "latency_p95_ms"
    assert entry["workloads"] == ["sharded10m.vectors-q1"]


def test_a_traced_tiny_run_on_the_cpu_leaves_the_spread_out(run_cell):
    """Under a CPU profiler the port's spans record, but no K1 runs on a
    card: the line is whole and leaves the metric out."""
    timers.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            search = run_cell("sharded10m.vectors-q1", seconds=0.5, trace=True)
    finally:
        timers.clear()
    assert search["correct"] is True
    assert "index.shard_scan_ms_per_search.latency" in search["metrics"]
    assert NAME not in search["metrics"]
