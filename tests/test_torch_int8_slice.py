"""The query path on the int8 tier, JAX package vs port, on the same files.

``RAGManager(Config(index_dtype="int8"))`` of each package, flat (selector
"auto" resolves to "rerank") and IVF (nlist 8; its bf16 shadow on by
default), ingests the same 40 documents with one ``vocab.txt`` and one
``encoder_params.npz`` at small widths, on the CPU. The two encoders'
embeddings agree to ~1e-5 per element, which can move an int8 code across a
rounding boundary, so each saved index is cross-loaded into the other
package and searched there with the same query vectors: top-5 doc ids
identical, distances to rtol 1e-4 / atol 1e-3 (the rerank's float32
re-score is summed in another order).
"""

import numpy as np
import pytest

from rag_faiss_embedding_tpu.core import Config as JCfg
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.index.flat import FlatIndex as JFlat
from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
from rag_faiss_embedding_tpu.models import convert as jconvert
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu.rag import RAGManager as JManager
from rag_faiss_embedding_tpu_torch.core import Config as TCfg
from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex, VectorStore as TStore
from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

from .test_torch_slice import WIDTHS, _documents

RTOL, ATOL = 1e-4, 1e-3
KINDS = ("flat", "ivf")


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_slice")
    docs = _documents(tmp)
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    out = {}
    for kind in KINDS:
        for name, cls, cfg_cls, kw in (("jax", JManager, JCfg, {}),
                                       ("torch", TManager, TCfg, {"device": "cpu"})):
            base = tmp / kind / name
            tok.save(base / "data" / "vocab.txt")
            jconvert.export_params(params, base / "data" / "encoder_params.npz")
            cfg = cfg_cls(base_dir=base, model_name="offline-test", index_kind=kind,
                          ivf_nlist=8, index_dtype="int8")
            m = cls(config=cfg, **kw)
            assert m.initialize_database(docs) == 40
            out[kind, name] = m
    yield docs, out
    for m in out.values():
        m.cleanup()


def _queries(m, docs):
    return np.stack([m.embedder.embed_query(d["content"]) for d in docs[:6] + docs[-2:]])


def _same(a, b):
    (ad, ai), (bd, bi) = a, b
    assert ai == bi
    for x, y in zip(ad, bd):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_int8_manager_builds_its_index_and_serves(managers, kind):
    """The port's manager builds the int8 index the JAX manager builds, with
    the selector ``Config`` resolves, and serves requests with it; a second
    manager on the same files reloads it as "rerank" and answers alike."""
    docs, m = managers
    tm, jm = m[kind, "torch"], m[kind, "jax"]
    index, jindex = tm.vector_store.index, jm.vector_store.index
    assert tm.config.search_selector == jm.config.search_selector == "rerank"
    assert index.quantized and index.device.type == "cpu"
    if kind == "flat":
        assert isinstance(index, FlatIndex) and index.selector == jindex.selector == "rerank"
        assert index._shadow is not None
    else:
        assert isinstance(index, IVFFlatIndex) and index.nlist == 8
        assert index.rerank and index._sorted_shadow is not None
    engine = TEngine(tm.db, tm.vector_store, tm.embedder)
    hits = [engine.search(d["content"], top_k=5) for d in docs[:6]]
    assert all(len(h) == 5 for h in hits)
    assert sum(h[0]["id"] == d["id"] for h, d in zip(hits, docs)) >= 5
    again = TManager(config=tm.config, device="cpu")
    assert again.vector_store.index.quantized
    if kind == "flat":
        assert again.vector_store.index.selector == "rerank"
    else:
        assert again.vector_store.index._sorted_shadow is not None
    q = _queries(tm, docs)
    _same(again.vector_store.search(q, 5), tm.vector_store.search(q, 5))
    again.cleanup()


@pytest.mark.parametrize("kind", KINDS)
def test_int8_saved_indexes_cross_load(managers, kind):
    """Each package's saved int8 index, loaded by the other, answers the
    same queries as the live store that saved it. The JAX store reloads a
    flat rerank file as "exact" (its reload fault, pinned in
    ``tests/test_torch_flat_index.py``), so the port's flat file is read by
    ``FlatIndex.from_state_dict(selector="rerank")`` on the JAX side."""
    docs, m = managers
    tm, jm = m[kind, "torch"], m[kind, "jax"]
    q = _queries(tm, docs)
    t_from_j = TStore(index_path=jm.config.index_path, device="cpu")
    assert t_from_j.doc_ids == jm.vector_store.doc_ids
    _same(t_from_j.search(q, 5), jm.vector_store.search(q, 5))
    j_from_t = JStore(index_path=tm.config.index_path)
    if kind == "flat":
        state = tm.vector_store.index.state_dict()
        j_from_t.index = JFlat.from_state_dict(state, selector="rerank", use_pallas=False)
    assert j_from_t.doc_ids == tm.vector_store.doc_ids
    _same(j_from_t.search(q, 5), tm.vector_store.search(q, 5))


@pytest.mark.parametrize("kind", KINDS)
def test_int8_filter_and_delete_match_jax(managers, kind):
    """A filtered search and a delete on the port's index, and on the same
    index loaded by JAX (the JAX flat side with the rerank selector)."""
    docs, m = managers
    tm = m[kind, "torch"]
    jstore = JStore(index_path=tm.config.index_path)
    if kind == "flat":
        jstore.index = JFlat.from_state_dict(tm.vector_store.index.state_dict(),
                                             selector="rerank", use_pallas=False)
    query = tm.embedder.embed_query(docs[0]["content"])
    allowed = tm.db.select_ids({"url_prefix": "https://synthetic.example/"})
    t_out = tm.vector_store.search(query, 5, allowed_doc_ids=allowed)
    _same(t_out, jstore.search(query, 5, allowed_doc_ids=allowed))
    assert set(t_out[1]) <= set(allowed)
    gone = t_out[1][:2]
    assert tm.vector_store.remove_doc_ids(gone) == jstore.remove_doc_ids(gone) == 2
    t_out = tm.vector_store.search(query, 5)
    _same(t_out, jstore.search(query, 5))
    assert not set(gone) & set(t_out[1])
