"""The readers of the port's own spans (``program_spans``, and the eight
metrics that use it): on hand-made records and device events, on an
untraced run, on a program without the recorder, and on a tiny traced run
on the CPU under a CPU profiler (which switches the port's spans on)."""

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench.registry import Registry
from perfbench.tests.conftest import ROOT
from rag_faiss_embedding_tpu_torch.utils import timers

SEARCH = ["index.shard_scan_ms_per_search.latency", "index.merge_ms_per_search.latency",
          "index.host_wait_ms_per_search.latency", "device.host_bound_idle_share.latency"]
INGEST = ["encoder.tokenize_ms_per_row.ingest", "encoder.host_wait_ms_per_row.ingest",
          "store.commit_ms_per_row.ingest", "device.host_bound_idle_share.ingest"]
MS = 1_000_000


def _rec(sid, name, t0, t1, parent=None, **counts):
    return {"name": name, "t0_ns": t0, "t1_ns": t1, "id": sid, "parent": parent,
            "request": None, "counts": counts}


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers ``records`` in place of the port's recorder; the
    window is [0, 100 ms)."""
    state = {"records": [], "dropped": 0}
    monkeypatch.setattr(timers, "spans", lambda t0, t1: [
        r for r in state["records"] if t0 <= r["t0_ns"] < t1])
    monkeypatch.setattr(timers, "dropped", lambda: state["dropped"])
    return state


def _ctx(device=None):
    ctx = {"rec": {"t0": 0, "t1": 100 * MS}, "window_s": 0.1}
    if device is not None:
        ctx["device"] = device
    return ctx


def _read(name, ctx):
    return Registry(ROOT).reader(name).read(ctx)


def test_per_search_readers_sum_their_spans_over_the_searches(recorded):
    recorded["records"] = [
        _rec(1, "vector_store.search", 0, 10 * MS),
        _rec(2, "index.search", 1 * MS, 8 * MS, 1),
        *[_rec(3 + j, "sharded.shard_scan", (1 + j) * MS, (2 + j) * MS, 2, shard=j)
          for j in range(4)],
        _rec(7, "sharded.merge", 5 * MS, 8 * MS, 2, shards=4),
        _rec(8, "vector_store.to_host", 8 * MS, 9 * MS, 1),
        _rec(9, "vector_store.search", 20 * MS, 30 * MS),
        _rec(10, "sharded.merge", 21 * MS, 22 * MS, 9, shards=4),
        _rec(11, "vector_store.to_host", 22 * MS, 25 * MS, 9),
        _rec(12, "vector_store.search", 200 * MS, 210 * MS),  # after the window
    ]
    ctx = _ctx()
    assert _read(SEARCH[0], ctx) == pytest.approx(2.0)
    assert _read(SEARCH[1], ctx) == pytest.approx(2.0)
    assert _read(SEARCH[2], ctx) == pytest.approx(2.0)


def test_per_row_readers(recorded):
    recorded["records"] = [
        _rec(1, "encoder.tokenize", 0, 3 * MS, 9, rows=32, real_tokens=10, positions=64),
        _rec(2, "encoder.tokenize", 3 * MS, 4 * MS, 9, rows=8, real_tokens=5, positions=16),
        _rec(3, "encoder.to_host", 4 * MS, 8 * MS, 9, rows=40),
        _rec(4, "store.insert", 10 * MS, 20 * MS, 9, rows=256),
        _rec(5, "store.commit", 15 * MS, 17 * MS, 4),
        _rec(6, "store.insert", 30 * MS, 40 * MS, 9, rows=144),
        _rec(7, "store.commit", 35 * MS, 37 * MS, 6),
    ]
    ctx = _ctx()
    assert _read(INGEST[0], ctx) == pytest.approx(4 / 40)
    assert _read(INGEST[1], ctx) == pytest.approx(4 / 40)
    assert _read(INGEST[2], ctx) == pytest.approx(4 / 400)


def test_host_bound_idle_leaves_out_the_waits(recorded):
    """Card 0 busy 20 ms, idle 80, the host waiting 45 ms (5 of them while
    the card is busy): 40% host bound; card 1 idle throughout, 55% outside
    the wait; the mean 47.5%."""
    recorded["records"] = [
        _rec(1, "vector_store.to_host", 15 * MS, 60 * MS, None),
        _rec(2, "encoder.forward", 60 * MS, 90 * MS, None),  # not a wait
    ]
    events = [("scan_partial", 0, 10 * MS, 20 * MS), ("copy", 0, 60 * MS, 70 * MS)]
    one = _ctx({"events": events, "busy_s": [0.02]})
    assert _read(INGEST[3], one) == pytest.approx(40.0)
    two = _ctx({"events": events, "busy_s": [0.02, 0.0]})
    assert _read(SEARCH[3], two) == pytest.approx(47.5)
    # a wait that runs past the window counts only inside it
    recorded["records"][0] = _rec(1, "encoder.to_host", 95 * MS, 130 * MS, None)
    assert _read(INGEST[3], one) == pytest.approx(100 - 20 - 5)


@pytest.mark.parametrize("name", SEARCH + INGEST)
def test_every_reader_is_silent_without_spans(recorded, monkeypatch, name):
    device = {"events": [("scan_partial", 0, 0, MS)], "busy_s": [0.001]}
    assert _read(name, _ctx(device)) is None  # nothing recorded: an untraced run
    recorded["records"] = [_rec(1, n, 0, MS, rows=1) for n in (
        "vector_store.search", "sharded.shard_scan", "sharded.merge",
        "vector_store.to_host", "encoder.tokenize", "encoder.to_host")]
    recorded["dropped"] = 1
    assert _read(name, _ctx(device)) is None  # part of the window is missing
    monkeypatch.delattr(timers, "spans")
    assert _read(name, _ctx(device)) is None  # a program without the recorder


def test_every_new_metric_has_a_reader_and_an_entry():
    reg = Registry(ROOT)
    entries = {m["name"]: m for m in reg.bench["per_layer"]}
    for name in SEARCH + INGEST:
        m = entries[name]
        assert m["unit"] == reg.reader(name).UNIT
        assert m["workloads"] == (["sharded10m.vectors-q1"] if name in SEARCH
                                  else ["flat1m.ingest-stream"])


def test_a_traced_tiny_run_reads_the_port_s_spans(run_cell):
    """Under a CPU profiler the port's spans record in the window: the
    span readers read numbers, and the sharded search's three parts fit in
    the wrapper's time a search (the device metrics need a card)."""
    timers.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            search = run_cell("sharded10m.vectors-q1", seconds=0.5, trace=True)
            ingest = run_cell("flat1m.ingest-stream", seconds=0.5, trace=True)
    finally:
        timers.clear()
    m = search["metrics"]
    parts = [m[n]["value"] for n in SEARCH[:3]]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= m["index.search_ms_per_call.latency"]["value"]
    for name in INGEST[:3]:
        assert ingest["metrics"][name]["value"] > 0, name
    assert SEARCH[3] not in m and INGEST[3] not in ingest["metrics"]
