"""Streaming writes through ``RAGManager``, JAX package vs port.

The server's ``POST /documents`` and ``DELETE /documents`` call
``RAGManager.add_documents`` and ``delete_documents``. Here flat, IVF and PQ
managers of both packages ingest the same 40 documents (one ``vocab.txt``
and one ``encoder_params.npz``, small widths, the CPU), then take the same
writes: a url re-added with new content (its old vector tombstoned), two
new documents, and a delete by id and by url (one url unknown), persisted.
Both must agree on the counts, the SQLite rows and the index's id mapping,
and each saved index must load in the other package and answer as the live
one (the IVF and PQ tiers train from different RNGs, so their live indexes
are compared through those cross-loads; distances by the tolerance of
``tests/test_torch_pq_slice.py``).
"""

import numpy as np
import pytest

from rag_faiss_embedding_tpu.core import Config as JCfg
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
from rag_faiss_embedding_tpu.models import convert as jconvert
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu.rag import RAGManager as JManager
from rag_faiss_embedding_tpu_torch.core import Config as TCfg
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

from .test_torch_pq_slice import _same_hits
from .test_torch_slice import WIDTHS, _documents

KINDS = {"flat": dict(index_kind="flat"),
         "ivf": dict(index_kind="ivf", ivf_nlist=8),
         "pq": dict(index_kind="pq")}


def _writes(docs):
    added = [
        {"url": docs[3]["url"], "title": "re-added",
         "content": "A replacement page about tensor cores and their caches."},
        {"url": "https://new.example/1", "title": "new 1",
         "content": "Streaming adds append rows at the index watermark."},
        {"url": "https://new.example/2", "title": "new 2",
         "content": "Tombstones hide deleted rows from every later search."},
    ]
    return added, dict(doc_ids=[docs[5]["id"]],
                       urls=[docs[10]["url"], "https://missing.example/x"], persist=True)


@pytest.fixture(scope="module", params=list(KINDS))
def managers(request, tmp_path_factory):
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"writes_{kind}")
    docs = _documents(tmp)
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    added, deleted = _writes(docs)
    out = {}
    for name, cls, cfg_cls, kw in (("jax", JManager, JCfg, {}),
                                   ("torch", TManager, TCfg, {"device": "cpu"})):
        data = tmp / name / "data"
        tok.save(data / "vocab.txt")
        jconvert.export_params(params, data / "encoder_params.npz")
        m = cls(config=cfg_cls(base_dir=tmp / name, model_name="offline-test",
                               **KINDS[kind]), **kw)
        assert m.initialize_database(docs) == 40
        counts = (m.add_documents(added), m.delete_documents(**deleted))
        out[name] = (m, counts)
    yield kind, docs, added, out
    for m, _ in out.values():
        m.cleanup()


def test_writes_give_the_same_counts_rows_and_mapping(managers):
    kind, docs, added, out = managers
    (jm, jcounts), (tm, tcounts) = out["jax"], out["torch"]
    assert tcounts == jcounts == (3, 2)
    assert tm.db.fetch_all_documents() == [
        {**d, "created_at": t["created_at"], "updated_at": t["updated_at"]}
        for d, t in zip(jm.db.fetch_all_documents(), tm.db.fetch_all_documents())]
    assert tm.db.get_document_count() == jm.db.get_document_count() == 40 + 2 - 2
    for m in (jm, tm):
        assert m.vector_store.nlive == 40 + 2 - 2
    assert tm.vector_store.doc_ids == jm.vector_store.doc_ids
    assert tm.vector_store.ntotal == jm.vector_store.ntotal
    old_id = docs[3]["id"]
    assert tm.db.get_document_by_id(old_id) is None  # replaced by url
    assert tm.db.get_document_id_by_url(docs[3]["url"]) == \
        jm.db.get_document_id_by_url(docs[3]["url"])


def test_written_indexes_cross_load_and_search_alike(managers):
    kind, docs, added, out = managers
    (jm, _), (tm, _) = out["jax"], out["torch"]
    live_ids = {d["id"] for d in tm.db.fetch_all_documents()}
    texts = [a["content"] for a in added] + [docs[3]["content"], docs[5]["content"],
                                              docs[10]["content"], docs[20]["content"]]
    queries = tm.embedder.generate_embeddings(texts)
    t_from_j = TStore(index_path=jm.config.index_path, device="cpu")
    j_from_t = JStore(index_path=tm.config.index_path)
    assert type(t_from_j.index) is type(tm.vector_store.index)
    assert t_from_j.doc_ids == jm.vector_store.doc_ids
    assert j_from_t.doc_ids == tm.vector_store.doc_ids
    assert t_from_j.nlive == j_from_t.nlive == 40
    for loaded, live in ((t_from_j, jm.vector_store), (j_from_t, tm.vector_store)):
        rows = np.asarray(live.index.vectors())
        _same_hits(loaded.search(queries, k=5), live.search(queries, k=5), queries, rows)
    _, ids = tm.vector_store.search(queries, k=5)
    assert all(set(row) <= live_ids for row in ids)  # no deleted or superseded row
    if kind == "flat":  # one exact index: the packages agree directly
        rows = np.asarray(tm.vector_store.index.vectors())
        _same_hits(tm.vector_store.search(queries, k=5), jm.vector_store.search(queries, k=5),
                   queries, rows)
    if kind != "pq":  # the codec blurs near neighbours, not exact rows
        new_ids = [tm.db.get_document_id_by_url(a["url"]) for a in added]
        assert [row[0] for row in ids[:3]] == new_ids
