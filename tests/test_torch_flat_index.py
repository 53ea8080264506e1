"""FlatIndex / VectorStore port vs the JAX package's, and cross-loading.

The same seeded numpy vectors go into both packages' indexes (CPU; the JAX
index on its lax scan, as its own tests run it). Tolerances: f32 distances
rtol 1e-5 / atol 1e-4; bf16 storage rtol 1e-2. Ids must be identical.
Files saved by either package must load in the other.
"""

import json

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index import FlatIndex as JFlat
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu_torch.index import FlatIndex as TFlat
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore

RTOL, ATOL = 1e-5, 1e-4


def _pair(dim, **kw):
    return (JFlat(dim, use_pallas=False, **kw),
            TFlat(dim, device="cpu", **kw))


def _assert_search_same(j, t, q, k, rtol=RTOL, **kw):
    jv, ji = j.search(q, k, **kw)
    tv, ti = t.search(q, k, **kw)
    assert ti.device.type == "cpu"
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=rtol, atol=ATOL)
    return ti.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_add_grow_search_match_jax(rng, dtype, metric):
    j, t = _pair(24, metric=metric, dtype=dtype)
    for n in (700, 900, 1300):  # crosses 1024 and 2048: two doublings
        vecs = rng.standard_normal((n, 24)).astype(np.float32)
        j.add(vecs)
        t.add(vecs)
    assert t.ntotal == j.ntotal == 2900
    assert t._capacity == j._capacity == 4096
    assert t._buf.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    # norms from the stored dtype; the two sums differ in order only
    np.testing.assert_allclose(t._sq.numpy(), np.asarray(j._sq), rtol=1e-6)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    rtol = 1e-2 if dtype == "bfloat16" else RTOL
    _assert_search_same(j, t, q, 7, rtol=rtol)
    _assert_search_same(j, t, q[0], 3, rtol=rtol)  # a single vector
    np.testing.assert_array_equal(t.vectors(), np.asarray(j.vectors(), np.float32))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_remove_ids_and_filter_mask_match_jax(rng, metric):
    j, t = _pair(16, metric=metric)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    j.add(vecs)
    t.add(vecs)
    q = vecs[:4] + 0.01
    assert t.remove_ids([0, 1, 1, 5, 999]) == j.remove_ids([0, 1, 1, 5, 999]) == 3
    assert t.remove_ids([5]) == 0
    assert t.nlive == j.nlive == 297
    ids = _assert_search_same(j, t, q, 6)
    assert not np.isin(ids, [0, 1, 5]).any()
    allow = np.zeros(300, bool)
    allow[100:140] = True
    ids = _assert_search_same(j, t, q, 6, filter_mask=allow)
    assert ((ids >= 100) & (ids < 140)).all()
    with pytest.raises(ValueError, match="filter_mask"):
        t.search(q, 3, filter_mask=allow[:10])


def test_reset_and_empty(rng):
    j, t = _pair(8)
    vecs = rng.standard_normal((10, 8)).astype(np.float32)
    j.add(vecs)
    t.add(vecs)
    t.reset()
    j.reset()
    assert t.ntotal == 0
    ids = _assert_search_same(j, t, vecs[:2], 3)
    assert (ids == -1).all()
    t.add(vecs[:3])
    j.add(vecs[:3])
    ids = _assert_search_same(j, t, vecs[:2], 5)  # k > ntotal pads
    assert (ids[:, 3:] == -1).all()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="the int8 tier"):
        TFlat(8, dtype="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="the int8 tier"):
        TFlat(8, selector="approx", device="cpu")
    with pytest.raises(ValueError):
        TFlat(8, metric="cosine", device="cpu")


def test_card_index_rejects_k_above_kmax(rng, tmp_path):
    """A CUDA index serves k up to the kernel's KMAX and raises ValueError
    above it, masked or not, before any tensor work; the engine and the
    manager let that error through instead of answering with no documents.
    The index here lives on the CPU and only claims the card, which is all
    the check reads."""
    from rag_faiss_embedding_tpu_torch.core import Config
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
    from rag_faiss_embedding_tpu_torch.ops import flat_scan
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    small = MiniLMConfig(vocab_size=256, hidden_size=16, num_layers=1,
                         num_heads=2, intermediate_size=32,
                         max_position_embeddings=64)
    cfg = Config(base_dir=tmp_path, model_name="offline-test")
    emb = EmbeddingPipeline(cfg=small, max_seq_length=64, device="cpu",
                            vocab_path=cfg.data_dir / "vocab.txt")
    m = RAGManager(cfg, embedder=emb, device="cpu")
    docs = [{"url": f"u{i}", "title": f"t{i}", "content": f"note {i} on topic {i % 3}"}
            for i in range(80)]
    m.initialize_database(docs)
    engine = QueryEngine(m.db, m.vector_store, m.embedder)
    k = flat_scan.KMAX + 1
    assert len(engine.search("topic 1", top_k=k)) == k  # the CPU serves any k
    index = m.vector_store.index
    index.device = torch.device("cuda")
    index.check_k(flat_scan.KMAX)
    for call in (lambda: index.search(np.zeros((1, 16), np.float32), k),
                 lambda: engine.search("topic 1", top_k=k),
                 lambda: engine.search_batch(["topic 1"], top_k=k),
                 lambda: m.search_similar_documents("topic 1", k=k)):
        with pytest.raises(ValueError, match="KMAX"):
            call()
    m.cleanup()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_cross_loads(rng, tmp_path, dtype):
    j, t = _pair(16, dtype=dtype)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    j.add(vecs)
    t.add(vecs)
    j.remove_ids([3, 7])
    t.remove_ids([3, 7])
    jstate, tstate = j.state_dict(), t.state_dict()
    assert sorted(jstate) == sorted(tstate)
    for key in jstate:
        a, b = np.asarray(jstate[key]), np.asarray(tstate[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b)
    np.savez(tmp_path / "j.npz", **jstate)
    np.savez(tmp_path / "t.npz", **tstate)
    load = lambda p: {k: (v.item() if v.ndim == 0 else v)
                      for k, v in np.load(p).items()}
    t2 = TFlat.from_state_dict(load(tmp_path / "j.npz"), device="cpu")
    j2 = JFlat.from_state_dict(load(tmp_path / "t.npz"), use_pallas=False)
    assert t2.dtype_name == dtype and t2.ndeleted == 2
    assert str(j2.dtype) == dtype and j2.ndeleted == 2
    rtol = 1e-2 if dtype == "bfloat16" else RTOL
    _assert_search_same(j2, t2, vecs[:5], 4, rtol=rtol)
    # a legacy void "|V2" bf16 save loads too
    if dtype == "bfloat16":
        legacy = dict(load(tmp_path / "j.npz"))
        legacy["vectors"] = legacy["vectors"].view("V2")
        t3 = TFlat.from_state_dict(legacy, device="cpu")
        assert torch.equal(t3._buf[:50], t2._buf[:50])


def test_vector_store_cross_loads_with_mapping(rng, tmp_path):
    vecs = rng.standard_normal((6, 16)).astype(np.float32)
    doc_ids = [9, 4, 1, 16, 12, 7]
    jstore = JStore(dimension=16, index_path=tmp_path / "j.tpu")
    jstore.index._use_pallas = False
    jstore.add_vectors(vecs, doc_ids)
    jstore.remove_doc_ids([16])
    jstore.save_index()
    tstore = TStore(dimension=16, index_path=tmp_path / "t.tpu", device="cpu")
    tstore.add_vectors(vecs, doc_ids)
    tstore.remove_doc_ids([16])
    tstore.save_index()
    assert (json.loads((tmp_path / "t.tpu.mapping").read_text())
            == json.loads((tmp_path / "j.tpu.mapping").read_text()))

    t_from_j = TStore(dimension=16, index_path=tmp_path / "j.tpu", device="cpu")
    j_from_t = JStore(dimension=16, index_path=tmp_path / "t.tpu")
    j_from_t.index._use_pallas = False
    for a, b in ((t_from_j, jstore), (tstore, j_from_t)):
        assert a.doc_ids == b.doc_ids
        da, ia = a.search(vecs, k=3)
        db_, ib = b.search(vecs, k=3)
        assert ia == ib
        for x, y in zip(da, db_):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
        assert all(16 not in row for row in ia)
        da, ia = a.search(vecs[2], k=3, allowed_doc_ids=[1, 7])
        assert ia == [1, 7]


def test_vector_store_sequential_fallback_and_kinds(rng, tmp_path):
    vecs = rng.standard_normal((5, 8)).astype(np.float32)
    jstore = JStore(dimension=8, index_path=tmp_path / "j.tpu")
    jstore.add_vectors(vecs, [30, 31, 32, 33, 34])
    jstore.save_index()
    (tmp_path / "j.tpu.mapping").unlink()
    tstore = TStore(dimension=8, index_path=tmp_path / "j.tpu", device="cpu")
    assert tstore.doc_ids == [0, 1, 2, 3, 4]
    _, ids = tstore.search(vecs[3], k=1)
    assert ids == [3]
    # a JAX-saved "pq" index loads by its kind; the sharded kinds still
    # raise, naming their tier
    from rag_faiss_embedding_tpu.index.pq import PQIndex as JPQ
    from rag_faiss_embedding_tpu_torch.index.pq import PQIndex as TPQ

    pq = JPQ(8, m=4, ksub=4, compute_dtype="f32", train_iters=2)
    pq.add(vecs)
    np.savez(tmp_path / "pq.npz", **{k: np.asarray(v) for k, v in pq.state_dict().items()})
    tstore.load_index(tmp_path / "pq.npz")
    assert isinstance(tstore.index, TPQ) and tstore.ntotal == 5
    assert tstore.doc_ids == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(tstore.index.vectors(), pq.vectors())
    np.savez(tmp_path / "sh.npz", kind="sharded_ivf", dim=8, metric="L2")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tstore.load_index(tmp_path / "sh.npz")
