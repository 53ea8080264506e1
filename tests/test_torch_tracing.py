"""The port's spans (``utils.timers.span``) on the CPU.

A span records only while a torch profiler records on the thread that
opens its root; it then records, on ``time.monotonic_ns``, its parent and
the request id of its root. Here: nothing records without a profiler; a
sharded search, a manager's add and a server's batch give the spans of
their layers, nested and sharing their request ids; the recorder's cap;
``device_trace``'s file of spans; and ``StageTimer``'s unchanged summary
on the same clock.
"""

import asyncio
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rag_faiss_embedding_tpu_torch.core import Config
from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.index import VectorStore
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu_torch.parallel import ShardedFlatIndex
from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager
from rag_faiss_embedding_tpu_torch.serve.api import make_app
from rag_faiss_embedding_tpu_torch.utils import timers
from rag_faiss_embedding_tpu_torch.utils.profiling import device_trace
from rag_faiss_embedding_tpu_torch.utils.timers import StageTimer, span
from perfbench.reference.deepseek_v2 import random_weights

WAIT_S = 60.0
WORDS = ["vector", "search", "tensor", "cores", "shard", "merge", "query", "index",
         "sqlite", "commit", "batch", "token", "encoder", "latency", "card", "host"]
SMALL = MiniLMConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                     intermediate_size=32, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def empty_recorder():
    timers.clear()
    yield
    timers.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _embedder():
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}
    return EmbeddingPipeline(model_name="offline-test", cfg=SMALL,
                             params=deterministic_params(SMALL, seed=1),
                             tokenizer=WordPieceTokenizer(vocab), max_seq_length=64,
                             device="cpu")


def _docs(n, first=0):
    rng = np.random.default_rng(first)
    return [{"url": f"https://t.example/{i}", "title": f"t{i}",
             "content": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 30))))}
            for i in range(first, first + n)]


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _inside(child, parent):
    return parent["t0_ns"] <= child["t0_ns"] <= child["t1_ns"] <= parent["t1_ns"]


def _assert_nested(records):
    """Every parent is recorded, holds its children's intervals and shares
    their request id."""
    by_id = {r["id"]: r for r in records}
    for r in records:
        if r["parent"] is None:
            assert r["request"] == r["id"], r
        else:
            parent = by_id[r["parent"]]
            assert r["request"] == parent["request"], r
            if r["name"] != "serve.queue_wait":  # timed from before its parent's code
                assert _inside(r, parent), (r, parent)


def _sharded_store():
    mesh = make_mesh({"db": 4}, devices=[torch.device("cpu")] * 4)
    store = VectorStore(16, index=ShardedFlatIndex(16, mesh, capacity=4096),
                        index_path="/nonexistent/idx")
    rows = np.random.default_rng(0).standard_normal((4 * 1024, 16)).astype(np.float32)
    store.add_vectors(rows, list(range(1, len(rows) + 1)))
    return store, rows


def test_nothing_records_without_a_profiler(monkeypatch):
    store, rows = _sharded_store()
    store.search(rows[:3], 5)
    assert timers.spans() == [] and timers.dropped() == 0
    # off: one shared, falsy object, and no clock read
    monkeypatch.setattr(timers.time, "monotonic_ns", lambda: pytest.fail("clock read"))
    first = span("a", rows=3)
    with span("b") as second:
        pass
    assert first is second and not first
    assert timers.current() is None


def test_a_root_records_only_on_the_profiling_thread():
    seen = []

    def other():
        with span("elsewhere"):
            seen.append(timers.current())

    with _cpu_profile():
        t = threading.Thread(target=other)
        t.start()
        t.join(WAIT_S)
        with span("here"):
            pass
    assert not t.is_alive() and seen == [None]
    assert [r["name"] for r in timers.spans()] == ["here"]


def test_sharded_search_gives_one_root_with_every_stage():
    store, rows = _sharded_store()
    with _cpu_profile():
        store.search(rows[:2], 5)
    records = timers.spans()
    [root] = [r for r in records if r["parent"] is None]
    assert root["name"] == "vector_store.search"
    assert root["counts"] == {"queries": 2, "k": 5}
    by = _by_name(records)
    assert sorted(by) == ["index.search", "sharded.merge", "sharded.query_copy",
                          "sharded.shard_scan", "vector_store.map_ids",
                          "vector_store.search", "vector_store.to_host"]
    [search] = by["index.search"]
    scans = by["sharded.shard_scan"]
    assert [s["counts"] for s in scans] == [{"shard": j, "rows": 1024} for j in range(4)]
    assert all(s["parent"] == search["id"]
               for s in by["sharded.query_copy"] + scans + by["sharded.merge"])
    assert [c["counts"] for c in by["sharded.query_copy"]] == [{"cards": 4}]
    assert [m["counts"] for m in by["sharded.merge"]] == [{"shards": 4, "candidates": 20}]
    assert [r["parent"] for r in by["vector_store.to_host"] + by["vector_store.map_ids"]
            + [search]] == [root["id"]] * 3
    assert by["vector_store.map_ids"][0]["counts"] == {"hits": 10}
    assert {r["request"] for r in records} == {root["id"]}
    _assert_nested(records)
    # the stages in the order they ran
    order = sorted(records, key=lambda r: r["t0_ns"])
    assert [r["name"] for r in order] == (
        ["vector_store.search", "index.search", "sharded.query_copy"]
        + ["sharded.shard_scan"] * 4
        + ["sharded.merge", "vector_store.to_host", "vector_store.map_ids"])


def test_every_shard_s_query_is_on_its_card_before_the_first_launch(monkeypatch):
    """A copy between cards runs on the source card's stream, so a copy made
    after the first shard's launch would wait behind its scan: every query
    a shard's scan receives comes from a copy to that shard's card made
    before the first launch, and nothing is copied between the launches."""
    from rag_faiss_embedding_tpu_torch.ops import flat_scan

    store, rows = _sharded_store()
    log, inside = [], []
    real_to, real_search = torch.Tensor.to, flat_scan.flat_search

    def to(self, *args, **kwargs):
        out = real_to(self, *args, **kwargs)
        if not inside:  # the scan's own (plain version's) moves are not the search's
            log.append(("copy", out, out.device))
        return out

    def flat_search(q, db, *args, **kwargs):
        log.append(("launch", q, db.device))
        inside.append(1)
        try:
            return real_search(q, db, *args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(flat_scan, "flat_search", flat_search)
    monkeypatch.setattr(torch.Tensor, "to", to)
    store.search(rows[:2], 5)
    monkeypatch.undo()
    kinds = [kind for kind, _, _ in log]
    first, last = kinds.index("launch"), len(kinds) - kinds[::-1].index("launch")
    assert kinds[first:last] == ["launch"] * 4
    launches = [(q, dev) for kind, q, dev in log[first:last]]
    copies = [(q, dev) for kind, q, dev in log[:first] if kind == "copy"]
    for q, dev in launches:
        assert q.shape == (2, 16)
        assert any(q is c and dev == d for c, d in copies)


def test_manager_add_gives_the_ingest_spans(tmp_path):
    cfg = Config(base_dir=tmp_path, vector_dimension=SMALL.hidden_size, batch_size=4)
    manager = RAGManager(config=cfg, embedder=_embedder(), device="cpu")
    docs = _docs(10, first=3)
    try:
        manager.add_documents(_docs(3))
        with _cpu_profile():
            assert manager.add_documents(docs) == 10
    finally:
        manager.cleanup()
    records = timers.spans()
    by = _by_name(records)
    [root] = by["manager.add_documents"]
    assert root["parent"] is None and root["counts"] == {"rows": 10}
    assert by["store.lookup_urls"][0]["counts"] == {"urls": 10}
    [insert] = by["store.insert"]
    assert insert["counts"] == {"rows": 10}
    assert [c["parent"] for c in by["store.commit"]] == [insert["id"]]
    contents = [d["content"] for d in docs]
    arrival = sum(manager.embedder.tokenizer.encode_batch(contents[i:i + 4], 64)[1].size
                  for i in range(0, 10, 4))
    assert by["encoder.embed"][0]["counts"] == {"rows": 10}
    assert sum(r["counts"]["positions"] for r in by["encoder.tokenize"]) <= arrival
    assert by["index.add"][0]["counts"] == {"rows": 10}
    for name in ("encoder.tokenize", "encoder.forward", "encoder.to_host"):
        assert [r["counts"]["rows"] for r in by[name]] == [4, 4, 2], name
    for r in by["encoder.tokenize"]:
        assert 0 < r["counts"]["real_tokens"] <= r["counts"]["positions"]
        assert r["counts"]["positions"] % r["counts"]["rows"] == 0
    assert {r["request"] for r in records} == {root["id"]}
    _assert_nested(records)


def test_server_batch_carries_its_requests(tmp_path):
    emb = _embedder()
    manager = RAGManager(config=Config(base_dir=tmp_path, vector_dimension=16),
                         embedder=emb, device="cpu")
    manager.add_documents(_docs(12))
    engine = QueryEngine(manager.db, manager.vector_store, emb,
                         generator=AnswerGenerator(backend="extractive"))
    app = make_app(engine, Config(base_dir=tmp_path, serve_watchdog_interval_s=0))
    bodies = [json.dumps({"text": " ".join(WORDS[i:i + 3]), "top_k": 3,
                          "generate": False}).encode() for i in range(4)]

    async def main():
        await app.service.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(app.search(b) for b in bodies)), WAIT_S)
        finally:
            await asyncio.wait_for(app.service.stop(), WAIT_S)

    try:
        with _cpu_profile():
            answers = asyncio.run(main())
    finally:
        manager.cleanup()
    assert [status for status, _ in answers] == [200] * 4
    records = timers.spans()
    by = _by_name(records)
    by_id = {r["id"]: r for r in records}
    requests = by["serve.request"]
    batches = by["serve.batch"]
    assert len(requests) == 4 and all(r["parent"] is None for r in requests)
    assert all(b["parent"] is None for b in batches)
    assert sum(b["counts"]["rows"] for b in batches) == 4
    assert sorted(i for b in batches for i in b["counts"]["requests"]) == sorted(
        r["id"] for r in requests)
    waits = by["serve.queue_wait"]
    assert sorted(w["parent"] for w in waits) == sorted(r["id"] for r in requests)
    for w in waits:
        batch = by_id[w["counts"]["batch"]]
        assert batch["name"] == "serve.batch" and w["request"] in batch["counts"]["requests"]
        assert w["t0_ns"] <= w["t1_ns"] == batch["t0_ns"]
    # the engine's spans ran on the worker thread, under their batch
    for s in by["engine.search_batch"]:
        assert by_id[s["parent"]]["name"] == "serve.batch"
    for name in ("encoder.embed", "vector_store.search", "store.fetch"):
        assert {by_id[r["parent"]]["name"] for r in by[name]} == {"engine.search_batch"}
    assert len(by["engine.search_batch"]) == len(batches)
    _assert_nested(records)


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timers, "CAP", 3)
    with _cpu_profile():
        for i in range(5):
            with span("s", i=i):
                pass
    assert [r["counts"]["i"] for r in timers.spans()] == [0, 1, 2]
    assert timers.dropped() == 2
    timers.clear()
    assert timers.spans() == [] and timers.dropped() == 0


def test_spans_read_by_start_time():
    with _cpu_profile():
        for i in range(3):
            with span("s", i=i):
                pass
    first, second, third = timers.spans()
    assert [r["counts"]["i"] for r in timers.spans(second["t0_ns"], third["t0_ns"])] == [1]
    assert timers.spans(third["t0_ns"] + 1) == []


def test_device_trace_writes_the_spans_it_saw(tmp_path):
    with span("before"):
        pass
    with device_trace(tmp_path / "trace"):
        with span("outer", rows=2) as s:
            with span("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            assert timers.current() is s
    [path] = (tmp_path / "trace").glob("spans-*.json")
    [trace] = (tmp_path / "trace").glob("trace-*.json")
    assert path.name[len("spans-"):] == trace.name[len("trace-"):]
    written = json.loads(path.read_text())
    assert [(r["name"], r["counts"]) for r in written] == [("inner", {}), ("outer", {"rows": 2})]
    assert written[0]["parent"] == written[1]["id"]


def test_stage_timer_keeps_its_summary_on_the_monotonic_clock(monkeypatch):
    timer = StageTimer()
    ticks = iter([1_000_000_000, 3_500_000_000])
    monkeypatch.setattr(timers.time, "monotonic_ns", lambda: next(ticks))
    with timer.stage("batch_search(n=3)"):
        pass
    monkeypatch.undo()
    with timer.stage("batch_search(n=3)"):
        pass
    summary = timer.summary()
    assert list(summary) == ["batch_search(n=3)"]
    st = summary["batch_search(n=3)"]
    assert list(st) == ["count", "total_s", "mean_s", "p50_s", "p99_s"]
    assert st["count"] == 2 and 2.5 <= st["total_s"] < 2.6 and st["p99_s"] == 2.5
    assert timer.report().splitlines()[1].startswith("batch_search(n=3)")


def _native_generator(tmp_path, answer=4):
    """The native generator (models/deepseek_v2.py) at a small size: one
    dense and two MoE layers, 8 experts of which 2 a token."""
    hf = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
          "moe_intermediate_size": 16, "num_hidden_layers": 3, "num_attention_heads": 2,
          "n_routed_experts": 8, "n_shared_experts": 2, "num_experts_per_tok": 2,
          "first_k_dense_replace": 1, "moe_layer_freq": 1, "kv_lora_rank": 16,
          "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
          "v_head_dim": 16, "rope_theta": 10000, "rms_norm_eps": 1e-6,
          "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                           "mscale": 0.707, "mscale_all_dim": 0.707,
                           "original_max_position_embeddings": 4096},
          "norm_topk_prob": False, "routed_scaling_factor": 1,
          "max_position_embeddings": 2048, "torch_dtype": "float32"}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    (tmp_path / "vocab.txt").write_text("\n".join(_embedder().tokenizer.vocab) + "\n")
    cfg = Config(base_dir=tmp_path, generator_backend="native", generator_model=str(tmp_path),
                 generation_max_length=answer)
    gen = AnswerGenerator.from_config(cfg, device="cpu")
    gen.load_state_dict(random_weights(hf, 0, "cpu"))
    return gen


def test_generator_spans_and_expert_counter(tmp_path):
    gen = _native_generator(tmp_path)
    context = " ".join(WORDS * 2)
    gen.generate("latency of the card", context)  # the first call reserves the cache
    assert timers.spans() == [] and timers.dropped() == 0  # no profiler: nothing
    with _cpu_profile():
        answer = gen.generate("latency of the card", context)
    records = timers.spans()
    _assert_nested(records)
    by = _by_name(records)
    assert sorted(by) == ["generator.decode", "generator.generate", "generator.prefill",
                          "generator.to_host"]
    [root], [prefill], [decode] = (by["generator.generate"], by["generator.prefill"],
                                   by["generator.decode"])
    n = root["counts"]["prompt_tokens"]
    assert root["parent"] is None and root["counts"]["new_tokens"] == 4
    assert answer == gen.native.tokenizer.decode(gen.native.last_ids)
    assert prefill["parent"] == root["id"] and decode["parent"] == root["id"]
    assert prefill["counts"]["tokens"] == n
    experts = prefill["counts"]["expert_tokens"]
    assert len(experts) == 8 and sum(experts) == n * 2 * 2  # 2 a token, two MoE layers
    assert prefill["counts"]["attention_launches"] == 0  # the CPU runs the plain version
    assert decode["counts"] == {"steps": 3, "context": n}
    copies = by["generator.to_host"]
    assert len(copies) == 4  # one a token
    assert [c["parent"] for c in copies] == [prefill["id"]] + [decode["id"]] * 3
