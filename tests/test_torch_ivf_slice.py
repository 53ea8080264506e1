"""The query path on the IVF tier, JAX package vs port, on the same files.

Both ``RAGManager(index_kind="ivf")``s ingest the same 40 documents (the
example HTML corpus plus seeded synthetic ones) with one ``vocab.txt`` and
one ``encoder_params.npz`` at small widths, on the CPU. Their k-means draw
from different RNGs, so their indexes differ; each saved index is therefore
cross-loaded into the other package's ``VectorStore`` and searched there:
top-5 doc ids identical, distances to rtol 1e-4 / atol 1e-3 (the encoders'
embeddings agree to ~1e-5 per element).
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
from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, VectorStore as TStore
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator as TGen
from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

from .test_torch_slice import WIDTHS, _documents

RTOL, ATOL = 1e-4, 1e-3
NLIST = 8


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ivf_slice")
    docs = _documents(tmp)
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    out = {}
    for name, cls, cfg_cls, kw in (("jax", JManager, JCfg, {}),
                                   ("torch", TManager, TCfg, {"device": "cpu"})):
        data = tmp / name / "data"
        tok.save(data / "vocab.txt")
        jconvert.export_params(params, data / "encoder_params.npz")
        cfg = cfg_cls(base_dir=tmp / name, model_name="offline-test", index_kind="ivf",
                      ivf_nlist=NLIST)
        m = cls(config=cfg, **kw)
        assert m.initialize_database(docs) == 40
        out[name] = m
    yield docs, out
    for m in out.values():
        m.cleanup()


def test_port_manager_builds_an_ivf_index(managers):
    docs, m = managers
    index = m["torch"].vector_store.index
    assert isinstance(index, IVFFlatIndex)
    assert index.nlist == NLIST and index.ntotal == 40 and index.device.type == "cpu"
    engine = TEngine(m["torch"].db, m["torch"].vector_store, m["torch"].embedder,
                     generator=TGen(backend="extractive"))
    for doc in docs[:5] + docs[-3:]:
        hits = engine.search(doc["content"], top_k=5)
        assert len(hits) == 5 and hits[0]["id"] == doc["id"]  # full probe
    rows = engine.search_batch([d["content"] for d in docs[::5]], top_k=3)
    assert [r[0]["id"] for r in rows] == [d["id"] for d in docs[::5]]
    assert engine.generate_response("tensor cores", rows[-1])


def test_saved_ivf_indexes_cross_load(managers):
    docs, m = managers
    queries = np.stack([m["torch"].embedder.embed_query(d["content"]) for d in docs[:6]])
    t_from_j = TStore(index_path=m["jax"].config.index_path, device="cpu")
    j_from_t = JStore(index_path=m["torch"].config.index_path)
    assert isinstance(t_from_j.index, IVFFlatIndex)
    assert t_from_j.doc_ids == m["jax"].vector_store.doc_ids
    assert j_from_t.doc_ids == m["torch"].vector_store.doc_ids
    for loaded, live in ((t_from_j, m["jax"].vector_store),
                         (j_from_t, m["torch"].vector_store)):
        ld, li = loaded.search(queries, k=5)
        vd, vi = live.search(queries, k=5)
        assert li == vi
        for a, b in zip(ld, vd):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_ivf_filtered_search_and_delete_match_jax(managers, tmp_path):
    docs, m = managers
    where = {"url_prefix": "https://synthetic.example/"}
    # the same index under both packages: the port's, reloaded by JAX
    j_store = JStore(index_path=m["torch"].config.index_path)
    query = m["torch"].embedder.embed_query(docs[0]["content"])
    allowed = m["torch"].db.select_ids(where)
    td, ti = m["torch"].vector_store.search(query, 5, allowed_doc_ids=allowed)
    jd, ji = j_store.search(query, 5, allowed_doc_ids=allowed)
    assert ti == ji and set(ti) <= set(allowed)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    gone = ti[:2]
    assert m["torch"].vector_store.remove_doc_ids(gone) == j_store.remove_doc_ids(gone) == 2
    td, ti = m["torch"].vector_store.search(query, 5)
    jd, ji = j_store.search(query, 5)
    assert ti == ji and not set(gone) & set(ti)


def test_pq_and_ivf_pq_still_raise(tmp_path):
    """The PQ kinds no longer raise: each manager builds its index as the
    JAX manager does (tests/test_torch_pq_slice.py drives them)."""
    from rag_faiss_embedding_tpu_torch.index import PQIndex
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig

    small = MiniLMConfig(vocab_size=256, hidden_size=16, num_layers=1, num_heads=2,
                         intermediate_size=32, max_position_embeddings=64)
    for kind, extra in (("ivf", {"ivf_pq_m": 8}), ("pq", {})):
        cfg = TCfg(base_dir=tmp_path / kind, model_name="offline-test",
                   index_kind=kind, **extra)
        emb = EmbeddingPipeline(cfg=small, max_seq_length=64, device="cpu",
                                vocab_path=cfg.data_dir / "vocab.txt")
        m = TManager(config=cfg, embedder=emb, device="cpu")
        index = m.vector_store.index
        if kind == "pq":
            assert isinstance(index, PQIndex) and index.m == 2
        else:
            assert isinstance(index, IVFFlatIndex) and index.pq_m == 8
        m.cleanup()
