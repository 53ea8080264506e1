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
    """int8 storage and the "approx" / "rerank" selectors are ported (the
    int8 tier); what JAX refuses, the port refuses with the same error."""
    assert TFlat(8, dtype="int8", device="cpu").quantized
    assert TFlat(8, selector="approx", device="cpu").selector == "approx"
    t = TFlat(8, dtype="int8", selector="rerank", device="cpu")
    assert t._shadow.dtype == torch.bfloat16 and t.recall_target == 0.99
    assert TFlat(8, dtype="int8", selector="rerank", rerank_shadow=False,
                 device="cpu")._shadow is None
    assert TFlat(8, dtype="int8", device="cpu").recall_target == 0.995
    for kw in (dict(metric="cosine"), dict(selector="rerank"), dict(selector="fast")):
        with pytest.raises(ValueError):
            JFlat(8, **kw)
        with pytest.raises(ValueError):
            TFlat(8, device="cpu", **kw)


def _int8_pair(dim, selector, metric="L2", **kw):
    return (JFlat(dim, metric=metric, dtype="int8", selector=selector, use_pallas=False, **kw),
            TFlat(dim, metric=metric, dtype="int8", selector=selector, device="cpu", **kw))


@pytest.mark.parametrize("selector", ["exact", "approx", "rerank"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_int8_add_grow_remove_filter_match_jax(rng, selector, metric):
    """int8 storage through growth, tombstones and a filter, with each
    selector: the codes, scales and exact norms equal JAX's (the norms to
    the float32 summation order), the dequantized rows equal, and searches
    give JAX's ids with values to rtol 1e-5 / atol 1e-4 (the query norms and
    the rerank's re-score are summed in other orders)."""
    j, t = _int8_pair(24, selector, metric)
    for n in (700, 900, 1300):
        vecs = rng.standard_normal((n, 24)).astype(np.float32)
        j.add(vecs)
        t.add(vecs)
    assert t._capacity == j._capacity == 4096 and t._buf.dtype == torch.int8
    np.testing.assert_array_equal(t._buf.numpy(), np.asarray(j._buf))
    np.testing.assert_array_equal(t._scales.numpy(), np.asarray(j._scales))
    np.testing.assert_allclose(t._sq.numpy(), np.asarray(j._sq), rtol=1e-6)
    if selector == "rerank":
        np.testing.assert_array_equal(t._shadow.float().numpy(),
                                      np.asarray(j._shadow, np.float32))
    np.testing.assert_array_equal(t.vectors(), np.asarray(j.vectors()))
    q = rng.standard_normal((5, 24)).astype(np.float32)
    _assert_search_same(j, t, q, 7)
    _assert_search_same(j, t, q[0], 3)
    assert t.remove_ids([0, 1, 5]) == j.remove_ids([0, 1, 5]) == 3
    ids = _assert_search_same(j, t, q, 10)
    assert not np.isin(ids, [0, 1, 5]).any()
    allow = np.zeros(2900, bool)
    allow[100:140] = True
    ids = _assert_search_same(j, t, q, 50, filter_mask=allow)
    assert ((ids[:, :40] >= 100) & (ids[:, :40] < 140)).all() and (ids[:, 40:] == -1).all()
    t.reset()
    j.reset()
    assert (_assert_search_same(j, t, q, 3) == -1).all()


@pytest.mark.parametrize("selector,shadow", [("exact", False), ("rerank", True),
                                             ("rerank", False)])
def test_int8_state_dict_cross_loads(rng, tmp_path, selector, shadow):
    """int8 files cross-load both ways, lossless (codes, scales, exact norms,
    the bf16 shadow as its bits, tombstones): JAX's keys and dtypes, and each
    reloaded index searches as the other package's did before the save."""
    j, t = _int8_pair(16, selector, rerank_shadow=shadow)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    for index in (j, t):
        index.add(vecs)
        index.remove_ids([3, 7])
    jstate, tstate = j.state_dict(), t.state_dict()
    assert sorted(jstate) == sorted(tstate)
    assert ("shadow" in tstate) == shadow
    for key in jstate:
        a, b = np.asarray(jstate[key]), np.asarray(tstate[key])
        assert a.dtype == b.dtype, key
        if key == "sqnorms":
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    np.savez(tmp_path / "j.npz", **jstate)
    np.savez(tmp_path / "t.npz", **tstate)
    load = lambda p: {k: (v.item() if v.ndim == 0 else v) for k, v in np.load(p).items()}
    kw = dict(selector=selector, rerank_shadow=shadow)
    t2 = TFlat.from_state_dict(load(tmp_path / "j.npz"), device="cpu", **kw)
    j2 = JFlat.from_state_dict(load(tmp_path / "t.npz"), use_pallas=False, **kw)
    assert t2.quantized and t2.ndeleted == 2 and j2.ndeleted == 2
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _assert_search_same(j, t2, q, 5)
    _assert_search_same(j2, t, q, 5)
    np.testing.assert_array_equal(t2._sq[:300].numpy(), np.asarray(j._sq[:300]))


def test_jax_int8_rerank_reload_fault_is_not_copied(rng, tmp_path):
    """A JAX ``VectorStore(dtype="int8", selector="rerank")`` saves its bf16
    shadow, but the JAX store reloads it as selector "exact" with no shadow
    (``VectorStore.load_index`` passes no selector to ``from_state_dict``):
    pinned here. The port loads the same file as "rerank" with the shadow,
    and answers as the JAX store did before the save."""
    vecs = rng.standard_normal((400, 16)).astype(np.float32)
    q = vecs[::40] + 0.05 * rng.standard_normal((10, 16)).astype(np.float32)
    path = tmp_path / "int8.tpu"
    jstore = JStore(dimension=16, dtype="int8", selector="rerank", index_path=path)
    jstore.add_vectors(vecs, list(range(1000, 1400)))
    jd, ji = jstore.search(q, k=5)
    jstore.save_index()
    assert "shadow" in np.load(path).files

    jback = JStore(dimension=16, index_path=path)
    assert jback.index.selector == "exact" and jback.index._shadow is None  # the fault
    tback = TStore(dimension=16, index_path=path, device="cpu")
    assert tback.index.selector == "rerank" and tback.index.quantized
    np.testing.assert_array_equal(tback.index._shadow[:400].float().numpy(),
                                  np.asarray(jstore.index._shadow[:400], np.float32))
    td, ti = tback.search(q, k=5)
    assert ti == ji
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # a port-saved rerank store reloads as "rerank" too, in the port
    tback.save_index(tmp_path / "again.tpu")
    again = TStore(dimension=16, index_path=tmp_path / "again.tpu", device="cpu")
    assert again.index.selector == "rerank"
    assert again.search(q, k=5)[1] == ji


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("k", [1, 64, 65, 1000])
@pytest.mark.parametrize("masked", [False, True])
def test_route_by_k_mask_and_use_pallas(monkeypatch, k, masked, use_pallas):
    """Every search, whatever its k, mask or ``use_pallas`` (taken for the
    JAX API, no effect), goes to the flat-scan wrapper once, with the mask
    as its ``dead`` rows: the wrapper launches K1 on a card and runs the
    plain scan on the CPU. The results are the JAX index's."""
    from rag_faiss_embedding_tpu_torch.ops import flat_scan

    calls = []
    real = flat_scan.flat_search

    def recording(*args, **kw):
        calls.append(kw.get("dead"))
        return real(*args, **kw)

    monkeypatch.setattr(flat_scan, "flat_search", recording)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((700, 8)).astype(np.float32)
    j, t = (JFlat(8, use_pallas=False), TFlat(8, device="cpu", use_pallas=use_pallas))
    for index in (j, t):
        index.add(vecs)
        if masked:
            index.remove_ids([2, 40])
    ids = _assert_search_same(j, t, vecs[:3] + 0.01, k)
    assert len(calls) == 1 and (calls[0] is not None) == masked
    if masked:
        assert not np.isin(ids, [2, 40]).any()
        assert bool(calls[0][[2, 40]].all()) and int(calls[0].sum()) == 2


@pytest.mark.parametrize("k", [65, 100, 1000])
def test_cpu_serves_any_k_like_jax(rng, k):
    j, t = _pair(16)
    vecs = rng.standard_normal((700, 16)).astype(np.float32)
    j.add(vecs)
    t.add(vecs)
    t.remove_ids([3])
    j.remove_ids([3])
    ids = _assert_search_same(j, t, vecs[:3] + 0.01, k)
    assert (ids[:, 699:] == -1).all() and not (ids == 3).any()


def test_query_engine_serves_top_k_100(tmp_path):
    """The engine, ``search_batch`` and the manager answer a top_k above the
    card kernel's KMAX (100 of 120 documents), as the JAX engine does."""
    from rag_faiss_embedding_tpu_torch.core import Config
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    small = MiniLMConfig(vocab_size=256, hidden_size=16, num_layers=1,
                         num_heads=2, intermediate_size=32,
                         max_position_embeddings=64)
    cfg = Config(base_dir=tmp_path, model_name="offline-test")
    emb = EmbeddingPipeline(cfg=small, max_seq_length=64, device="cpu",
                            vocab_path=cfg.data_dir / "vocab.txt")
    m = RAGManager(cfg, embedder=emb, device="cpu")
    docs = [{"url": f"u{i}", "title": f"t{i}", "content": f"note {i} on topic {i % 3}"}
            for i in range(120)]
    m.initialize_database(docs)
    engine = QueryEngine(m.db, m.vector_store, m.embedder)
    hits = engine.search("topic 1", top_k=100)
    assert len(hits) == 100 and len({h["id"] for h in hits}) == 100
    dist = [h["distance"] for h in hits]
    assert dist == sorted(dist)
    assert [len(h) for h in engine.search_batch(["topic 1", "note 7"], top_k=100)] == [100, 100]
    assert len(m.search_similar_documents("topic 1", k=100)) == 100
    m.cleanup()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_card_index_serves_k_above_kmax(masked):
    """A card index once refused k above the kernel's KMAX; it now serves
    k = 64, 65, 100, 1,000 and 5,000 (every row; the lists in global
    memory) through K1, tombstones included (one launch per search), with
    the CPU index's results under ``assert_same_topk``'s rule: values within
    rtol 1e-5 x (max ||q||^2 + max ||x||^2), ids that differ only at
    near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rag_faiss_embedding_tpu_torch.ops import flat_scan

    rng = np.random.default_rng(0)  # no conftest on the card
    vecs = rng.standard_normal((5000, 32)).astype(np.float32)
    removed = [0, 17, 4999] if masked else []
    card, cpu = TFlat(32, device="cuda"), TFlat(32, device="cpu")
    for t in (card, cpu):
        t.add(vecs)
        t.remove_ids(removed)
    n_live = 5000 - len(removed)
    for nq in (7, 30):  # the warp path either side of TILED_MIN_Q
        q = rng.standard_normal((nq, 32)).astype(np.float32)
        atol = 1e-5 * float((q.astype(np.float64) ** 2).sum(1).max()
                            + (vecs.astype(np.float64) ** 2).sum(1).max())
        for k in (64, 65, 100, 1000, 5000):
            launches = flat_scan.flat_search.launches
            kv, ki = card.search(q, k)
            torch.cuda.synchronize()
            assert flat_scan.flat_search.launches == launches + 1
            cv, ci = cpu.search(q, k)
            kv, ki = kv.cpu().numpy().astype(np.float64), ki.cpu().numpy()
            cv = cv.numpy().astype(np.float64)
            found = min(k, n_live)
            assert (ki[:, :found] >= 0).all() and (ki[:, found:] == -1).all()
            assert (cv[:, found:] == np.inf).all() and (kv[:, found:] == np.inf).all()
            np.testing.assert_allclose(kv[:, :found], cv[:, :found], rtol=1e-5, atol=atol)
            own = ((q.astype(np.float64)[:, None]
                    - vecs.astype(np.float64)[ki[:, :found]]) ** 2).sum(-1)
            np.testing.assert_allclose(kv[:, :found], own, rtol=1e-5, atol=atol)
            assert all(len(np.unique(row[:found])) == found for row in ki)
            assert not np.isin(ki, removed).any()


def test_jax_saved_sharded_flat_loads_as_flat(rng, tmp_path):
    """A JAX ``ShardedFlatIndex`` on a one-device mesh, 100 rows and one
    removed doc id, saved by the JAX ``VectorStore``: the port loads it as
    its own ``ShardedFlatIndex`` (a CPU store with no mesh: one CPU shard)
    with its tombstone, searches to the JAX ids and distances, and re-saves
    it as kind "sharded_flat", which JAX loads again."""
    from rag_faiss_embedding_tpu.core.mesh import make_mesh
    from rag_faiss_embedding_tpu.parallel import ShardedFlatIndex
    from rag_faiss_embedding_tpu_torch.parallel import ShardedFlatIndex as TSharded

    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    doc_ids = list(range(1000, 1100))
    jstore = JStore(dimension=16, index_path=tmp_path / "sh.tpu",
                    index=ShardedFlatIndex(16, mesh=make_mesh({"db": 1})))
    jstore.add_vectors(vecs, doc_ids)
    assert jstore.remove_doc_ids([1042]) == 1
    jstore.save_index()
    assert str(np.load(tmp_path / "sh.tpu")["kind"]) == "sharded_flat"

    tstore = TStore(dimension=16, index_path=tmp_path / "sh.tpu", device="cpu")
    assert isinstance(tstore.index, TSharded) and tstore.index.n_dev == 1
    assert tstore.ntotal == 100 and tstore.nlive == 99 and tstore.doc_ids == jstore.doc_ids
    q = vecs[38:46] + 0.01
    jd, ji = jstore.search(q, k=5)
    td, ti = tstore.search(q, k=5)
    assert ti == ji and all(1042 not in row for row in ti)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)

    tstore.save_index(tmp_path / "resaved.tpu")
    assert str(np.load(tmp_path / "resaved.tpu")["kind"]) == "sharded_flat"
    again = JStore(dimension=16, index_path=tmp_path / "resaved.tpu")
    assert isinstance(again.index, ShardedFlatIndex) and again.nlive == 99
    assert again.search(q, k=5)[1] == ji


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
    # a JAX-saved "pq" index loads by its kind, and so does a JAX-saved
    # "sharded_ivf" one (onto one CPU shard: a CPU store with no mesh)
    from rag_faiss_embedding_tpu.core.mesh import make_mesh
    from rag_faiss_embedding_tpu.index.pq import PQIndex as JPQ
    from rag_faiss_embedding_tpu.parallel.sharded_ivf import ShardedIVFIndex as JSIVF
    from rag_faiss_embedding_tpu_torch.index.pq import PQIndex as TPQ
    from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex as TSIVF

    pq = JPQ(8, m=4, ksub=4, compute_dtype="f32", train_iters=2)
    pq.add(vecs)
    np.savez(tmp_path / "pq.npz", **{k: np.asarray(v) for k, v in pq.state_dict().items()})
    tstore.load_index(tmp_path / "pq.npz")
    assert isinstance(tstore.index, TPQ) and tstore.ntotal == 5
    assert tstore.doc_ids == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(tstore.index.vectors(), pq.vectors())
    more = rng.standard_normal((64, 8)).astype(np.float32)
    sivf = JSIVF(8, make_mesh({"db": 2}), nlist=4, nprobe=4, train_iters=3)
    sivf.build(more)
    np.savez(tmp_path / "sh.npz", **{k: np.asarray(v) for k, v in sivf.state_dict().items()})
    tstore.load_index(tmp_path / "sh.npz")
    assert isinstance(tstore.index, TSIVF) and tstore.index.n_dev == 1
    assert tstore.ntotal == 64 and tstore.doc_ids == list(range(64))
    d, ids = tstore.search(more[:3], k=4)
    jd, jids = sivf.search(more[:3], 4)
    assert ids == np.asarray(jids).tolist() and [row[0] for row in ids] == [0, 1, 2]
    for a, b in zip(d, np.asarray(jd)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
