"""The query path on the PQ tier, JAX package vs port, on the same files.

``RAGManager(index_kind="pq")`` and ``RAGManager(index_kind="ivf",
ivf_pq_m=8)`` of both packages ingest the same 40 documents (as
tests/test_torch_ivf_slice.py) with one ``vocab.txt`` and one
``encoder_params.npz`` at small widths, on the CPU. Codebooks and k-means
draw from different RNGs, so each saved index is cross-loaded into the other
package's ``VectorStore`` and searched there on the same query embeddings:
top-5 doc ids identical except where distances tie, distances to rtol 1e-3
relative to the largest ||q||^2 + ||x̂||^2 (the default compute dtype is
bf16: both packages round codewords and queries to bf16 and sum their
products in float32 in different orders).
"""

import numpy as np
import pytest

from rag_faiss_embedding_tpu.core import Config
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
from rag_faiss_embedding_tpu.models import convert as jconvert
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu.rag import RAGManager as JManager
from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, PQIndex
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator as TGen
from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

from .test_torch_slice import WIDTHS, _documents

RTOL = 1e-3
KINDS = {"pq": dict(index_kind="pq"),
         "ivfpq": dict(index_kind="ivf", ivf_nlist=8, ivf_pq_m=8)}


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pq_slice")
    docs = _documents(tmp)
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    out = {}
    for kind, kw in KINDS.items():
        for name, cls, extra in (("jax", JManager, {}), ("torch", TManager, {"device": "cpu"})):
            base = tmp / kind / name
            tok.save(base / "data" / "vocab.txt")
            jconvert.export_params(params, base / "data" / "encoder_params.npz")
            cfg = Config(base_dir=base, model_name="offline-test", **kw)
            m = cls(config=cfg, **extra)
            assert m.initialize_database(docs) == 40
            out[kind, name] = m
    yield docs, out
    for m in out.values():
        m.cleanup()


def _same_hits(a, b, q, rows):
    """(distances, ids) lists of two stores agree: distances within the
    tolerance at every slot, ids equal except where distances tie."""
    (da, ia), (db_, ib) = a, b
    da, db_ = np.asarray(da), np.asarray(db_)
    atol = RTOL * float((q.astype(np.float64) ** 2).sum(-1).max()
                        + (rows.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(da, db_, rtol=RTOL, atol=atol)
    ia, ib = np.asarray(ia), np.asarray(ib)
    for row in np.argwhere(ia != ib):
        r = tuple(row)
        assert abs(da[r] - db_[r]) <= atol + RTOL * abs(db_[r])
        tied = np.abs(np.delete(db_[r[0]], r[1]) - db_[r]) <= 2 * atol
        assert tied.any() or r[1] == ia.shape[-1] - 1


def test_port_managers_build_pq_indexes(managers):
    docs, m = managers
    pq = m["pq", "torch"].vector_store.index
    assert isinstance(pq, PQIndex) and pq.m == WIDTHS["hidden_size"] // 8
    assert pq.ntotal == 40 and pq.device.type == "cpu" and pq.is_trained
    ivf = m["ivfpq", "torch"].vector_store.index
    assert isinstance(ivf, IVFFlatIndex) and ivf.pq_m == 8 and ivf.nlist == 8
    assert ivf.ntotal == 40 and ivf.pq_codebooks is not None
    for kind in KINDS:
        tm = m[kind, "torch"]
        engine = TEngine(tm.db, tm.vector_store, tm.embedder,
                         generator=TGen(backend="extractive"))
        hits = [engine.search(d["content"], top_k=5) for d in docs[:8]]
        assert all(len(h) == 5 for h in hits)
        # the codec blurs near neighbours, not the document itself
        assert sum(h[0]["id"] == d["id"] for h, d in zip(hits, docs)) >= 6
        rows = engine.search_batch([d["content"] for d in docs[::5]], top_k=3)
        assert [len(r) for r in rows] == [3] * 8
        assert engine.generate_response("tensor cores", rows[-1])


@pytest.mark.parametrize("kind", list(KINDS))
def test_saved_pq_indexes_cross_load(managers, kind):
    docs, m = managers
    tm, jm = m[kind, "torch"], m[kind, "jax"]
    queries = np.stack([tm.embedder.embed_query(d["content"]) for d in docs[:6]])
    t_from_j = TStore(index_path=jm.config.index_path, device="cpu")
    j_from_t = JStore(index_path=tm.config.index_path)
    assert type(t_from_j.index) is type(tm.vector_store.index)
    assert t_from_j.doc_ids == jm.vector_store.doc_ids
    assert j_from_t.doc_ids == tm.vector_store.doc_ids
    for loaded, live in ((t_from_j, jm.vector_store), (j_from_t, tm.vector_store)):
        rows = np.asarray(live.index.vectors())
        _same_hits(loaded.search(queries, k=5), live.search(queries, k=5), queries, rows)


@pytest.mark.parametrize("kind", list(KINDS))
def test_pq_filtered_search_and_delete_match_jax(managers, kind):
    docs, m = managers
    tm = m[kind, "torch"]
    where = {"url_prefix": "https://synthetic.example/"}
    # the same index under both packages: the port's, reloaded by JAX
    j_store = JStore(index_path=tm.config.index_path)
    query = tm.embedder.embed_query(docs[0]["content"])
    rows = np.asarray(tm.vector_store.index.vectors())
    allowed = tm.db.select_ids(where)
    t_hits = tm.vector_store.search(query, 5, allowed_doc_ids=allowed)
    _same_hits(t_hits, j_store.search(query, 5, allowed_doc_ids=allowed), query, rows)
    assert set(t_hits[1]) <= set(allowed)
    gone = t_hits[1][:2]
    assert tm.vector_store.remove_doc_ids(gone) == j_store.remove_doc_ids(gone) == 2
    t_hits = tm.vector_store.search(query, 5)
    _same_hits(t_hits, j_store.search(query, 5), query, rows)
    assert not set(gone) & set(t_hits[1])
