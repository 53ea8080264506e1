"""Every cell's whole run on the CPU at tiny sizes: sound runs read correct,
the controls and the planted faults do not."""

import numpy as np
import pytest

from rag_faiss_embedding_tpu_torch.index.vector_store import VectorStore
from rag_faiss_embedding_tpu_torch.parallel import sharded
from rag_faiss_embedding_tpu_torch.rag.engine import QueryEngine
from rag_faiss_embedding_tpu_torch.rag.manager import RAGManager

CELLS = ["flat1m.http-poisson", "ivf1m.vectors-q1024", "flat1m.ingest-stream",
         "sharded10m.vectors-q1"]
CONTROLS = {"flat1m.http-poisson": "tf32", "ivf1m.vectors-q1024": "fp8",
            "flat1m.ingest-stream": "tf32", "sharded10m.vectors-q1": "tf32"}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_cell, cell):
    r = run_cell(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_cell, cell):
    r = run_cell(cell, control=CONTROLS[cell])
    assert not r["correct"], r["checks"]


def _altered_search(monkeypatch):
    """An answer altered where it is produced: each query's first hit
    becomes the next document."""
    real = VectorStore.search

    def search(self, q, k=5, allowed_doc_ids=None):
        d, ids = real(self, q, k, allowed_doc_ids)
        rows = [ids] if ids and not isinstance(ids[0], list) else ids
        for r in rows:
            if r:
                r[0] = r[0] % len(self.doc_ids) + 1
        return d, ids

    monkeypatch.setattr(VectorStore, "search", search)


def _half_search(monkeypatch):
    """Half of the batch left out: the second half of the queries get no
    answer."""
    real = VectorStore.search

    def search(self, q, k=5, allowed_doc_ids=None):
        d, ids = real(self, q, k, allowed_doc_ids)
        if ids and isinstance(ids[0], list):
            for j in range(len(ids) // 2, len(ids)):
                ids[j], d[j] = [], d[j][:0]
        return d, ids

    monkeypatch.setattr(VectorStore, "search", search)


def _half_batch_engine(monkeypatch):
    real = QueryEngine.search_batch

    def search_batch(self, queries, top_k=5, where=None):
        keep = queries[: len(queries) // 2]  # a batch of one loses its only query
        out = real(self, keep, top_k, where) if keep else []
        return out + [[] for _ in queries[len(out):]]

    monkeypatch.setattr(QueryEngine, "search_batch", search_batch)


def _unchanged_add(monkeypatch):
    """A step that returns its state unchanged: adds nothing."""
    monkeypatch.setattr(VectorStore, "add_vectors", lambda self, v, ids: None)


def _half_add(monkeypatch):
    real = RAGManager.add_documents

    def add(self, documents):
        return real(self, documents[: len(documents) // 2])

    monkeypatch.setattr(RAGManager, "add_documents", add)


def _altered_embedding(monkeypatch):
    real = VectorStore.add_vectors

    def add(self, vectors, ids):
        v = np.array(vectors, dtype=np.float32)
        v[:, 0] += 0.05
        return real(self, v, ids)

    monkeypatch.setattr(VectorStore, "add_vectors", add)


def _no_exchange(monkeypatch):
    """The exchange between cards left out: the merge sees the first shard
    only."""
    real = sharded.merge_shards
    monkeypatch.setattr(sharded, "merge_shards",
                        lambda parts, k, metric, device: real(parts[:1], k, metric, device))


FAULTS = [
    ("flat1m.http-poisson", _altered_search),
    ("flat1m.http-poisson", _half_batch_engine),
    ("ivf1m.vectors-q1024", _altered_search),
    ("ivf1m.vectors-q1024", _half_search),
    ("flat1m.ingest-stream", _unchanged_add),
    ("flat1m.ingest-stream", _half_add),
    ("flat1m.ingest-stream", _altered_embedding),
    ("sharded10m.vectors-q1", _no_exchange),
    ("sharded10m.vectors-q1", _altered_search),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_planted_fault_is_not_correct(run_cell, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_cell(cell)
    assert not r["correct"], r["checks"]


def test_traced_run_reports_its_layers(run_cell):
    r = run_cell("flat1m.ingest-stream", trace=True)
    m = r["metrics"]
    for name in ("encoder.ms_per_row.ingest", "tokenizer.pad_share.ingest",
                 "index.add_ms_per_row.ingest", "store.insert_ms_per_row.ingest"):
        assert m[name]["value"] > 0, name
    assert 0 < m["tokenizer.pad_share.ingest"]["value"] < 100
    assert "setup_s" not in m  # a traced run reports the per-layer metrics only


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:3])
def test_card_control_is_not_correct(run_cell, cuda_device, cell):
    """The controls with the card's own arithmetic at tiny sizes (the CPU
    emulates TF32, and sums float32 products in another order)."""
    r = run_cell(cell, control=CONTROLS[cell], device=None)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:3])
def test_card_sound_run_is_correct(run_cell, cuda_device, cell):
    r = run_cell(cell, device=None, trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
