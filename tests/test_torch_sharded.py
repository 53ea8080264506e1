"""The device mesh (core/mesh.py) and the sharded flat search
(parallel/sharded.py), port vs the JAX package.

JAX runs on ``make_mesh({"db": 4})`` (and 8, and {"data": 2, "db": 4}) over
conftest's 8 virtual CPU devices, the port on a mesh of as many
``cpu`` devices. Inputs come from a seeded numpy generator at the JAX tests'
sizes. Tolerance: ids equal except at near-ties (two ids whose float64
distances to the query agree within the value tolerance), values within
rtol 1e-5 x (max ||q||^2 + max ||x||^2), the scale of the terms that cancel
in a float32 distance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rag_faiss_embedding_tpu.core.mesh import make_mesh as jmesh
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.parallel import ShardedFlatIndex as JSharded
from rag_faiss_embedding_tpu.parallel import sharded_exact_search as j_search
from rag_faiss_embedding_tpu_torch.core import mesh as M
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.parallel import ShardedFlatIndex as TSharded
from rag_faiss_embedding_tpu_torch.parallel import sharded_exact_search as t_search

from .test_distance import numpy_exact

CPU = torch.device("cpu")
RTOL = 1e-5


def tmesh(shape):
    """The port's mesh over 8 CPU devices, as JAX's over its 8 virtual ones."""
    return M.make_mesh(shape, devices=[CPU] * 8)


def value_tol(q, x):
    return RTOL * (float((q.astype(np.float64) ** 2).sum(1).max())
                   + float((x.astype(np.float64) ** 2).sum(1).max()))


def dist64(q, x, ids, metric):
    """Float64 distance (L2) or score (IP) of each (query, id); nan at -1."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    rows = x64[np.maximum(ids, 0)]
    d = (((q64[:, None] - rows) ** 2).sum(-1) if metric == "L2"
         else np.einsum("qd,qkd->qk", q64, rows))
    return np.where(ids >= 0, d, np.nan)


def assert_topk_close(t_out, ref, q, x, metric="L2"):
    """Port (values, ids) against a reference (values, ids): ids equal but
    at near-ties, values within the tolerance, -1 slots in the same places."""
    tv, ti = (np.asarray(a.cpu() if torch.is_tensor(a) else a) for a in t_out)
    rv, ri = (np.asarray(a) for a in ref)
    tol = value_tol(q, x)
    np.testing.assert_array_equal(ti >= 0, ri >= 0)
    fin = ri >= 0
    np.testing.assert_allclose(tv[fin], rv[fin], rtol=0, atol=tol)
    assert np.isinf(tv[~fin]).all()
    differ = ti != ri
    if differ.any():
        gap = np.abs(dist64(q, x, ti, metric) - dist64(q, x, ri, metric))
        assert (gap[differ] <= tol).all(), "ids differ away from a near-tie"


# ---------------------------------------------------------------- the mesh
def test_mesh_construction_matches_jax():
    for shape in ({"db": 8}, {"data": 2, "db": -1}, {"db": 4}):
        t, j = tmesh(shape), jmesh(shape)
        assert t.shape == dict(j.shape) and t.axis_names == tuple(j.axis_names)
        assert t.size == j.size and t.axis_sizes == tuple(j.axis_sizes)
        assert t.devices.shape == j.devices.shape
    assert tmesh({"data": 2, "db": -1}).shape == {"data": 2, "db": 4}
    for bad in ({"db": 16}, {"data": -1, "db": -1}):
        with pytest.raises(ValueError):
            M.make_mesh(bad, devices=[CPU] * 8)
        with pytest.raises(ValueError):
            jmesh(bad)
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh({"data": 3, "db": -1}, devices=[CPU] * 8)
    m = tmesh({"data": 2, "db": 4})
    assert m.axis_devices("db") == [CPU] * 4 and m.local_mesh is m and not m.empty
    assert m.update(axis_names=("x", "y")).shape == {"x": 2, "y": 4}


def test_mesh_without_a_card_raises(monkeypatch):
    """The default devices are the visible cards; with none the mesh raises
    (it never moves to the CPU by itself)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.single_device_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSharded.from_state_dict({"dim": 4, "metric": "L2", "dtype": "float32",
                                  "vectors": np.zeros((0, 4), np.float32)})


def test_placements_split_and_copy():
    m = tmesh({"data": 2, "db": 4})
    x = torch.arange(8 * 3).view(8, 3)
    parts = M.sharding(m, "db").put_along(x, "db")
    assert len(parts) == 4
    assert all(torch.equal(p, x[2 * j:2 * j + 2]) for j, p in enumerate(parts))
    rows = M.sharding(m, "data", None).put_along(x, "data")
    assert torch.equal(rows[1], x[4:])
    assert all(torch.equal(p, x) for p in M.replicated(m).put_along(x, "db"))
    with pytest.raises(ValueError, match="does not split"):
        M.sharding(m, "db").put_along(x[:7], "db")
    with pytest.raises(ValueError, match="names axis"):
        M.sharding(m, "model")


# ------------------------------------------------------- sharded_exact_search
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_sharded_search_matches_jax_and_oracle(rng, metric):
    n, d, k = 1024, 32, 10
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    t = t_search(tmesh({"db": 8}), q, db, k, metric=metric, chunk_size=64)
    j = j_search(jmesh({"db": 8}), jnp.asarray(q), jnp.asarray(db), k, metric=metric,
                 chunk_size=64)
    assert t[0].shape == (6, k) and t[1].dtype == torch.int32
    assert_topk_close(t, j, q, db, metric)
    assert_topk_close(t, numpy_exact(q, db, k, metric), q, db, metric)


def test_sharded_search_with_query_sharding(rng):
    n, d, k = 512, 16, 5
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    t = t_search(tmesh({"data": 2, "db": 4}), q, db, k, chunk_size=64, data_axis="data")
    j = j_search(jmesh({"data": 2, "db": 4}), jnp.asarray(q), jnp.asarray(db), k,
                 chunk_size=64, data_axis="data")
    assert_topk_close(t, j, q, db)
    assert_topk_close(t, numpy_exact(q, db, k, "L2"), q, db)
    # each data row searches its own copy of the shards: passed per row,
    # they give the same answer as the global tensor placed per position
    per_row = [list(torch.from_numpy(db).split(n // 4)) for _ in range(2)]
    t2 = t_search(tmesh({"data": 2, "db": 4}), q, per_row, k, chunk_size=64,
                  data_axis="data")
    assert all(torch.equal(a, b) for a, b in zip(t, t2))


def test_shard_positions_follow_each_data_row():
    from rag_faiss_embedding_tpu_torch.parallel.sharded import _positions

    assert _positions(tmesh({"data": 2, "db": 4}), "db", "data")[1] == [
        (1, 0), (1, 1), (1, 2), (1, 3)]
    assert _positions(tmesh({"db": 2, "data": 2}), "db", "data")[1] == [(0, 1), (1, 1)]
    assert _positions(tmesh({"data": 2, "db": 4}), "db", None) == [
        [(0, 0), (0, 1), (0, 2), (0, 3)]]


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_dead_rows_k_past_rows_per_dev_and_ties_across_shards(rng, metric):
    """Dead rows never return; k above a shard's rows pads with -1; a row
    duplicated in two shards returns from both, the lower shard first (the
    all-gather order JAX's ``top_k`` keeps)."""
    n, d = 64, 16
    db = rng.standard_normal((n, d)).astype(np.float32)
    db[40] = db[3]     # shard 0 and shard 2 of 4 hold the same row
    db[57] = db[3]
    dead = np.zeros(n, bool)
    dead[[5, 17, 33, 57]] = True
    q = np.concatenate([db[3:4], rng.standard_normal((3, d)).astype(np.float32)])
    for k in (4, 20, 70):  # 16 rows per shard
        t = t_search(tmesh({"db": 4}), q, db, k, metric=metric, n_valid=60, dead=dead)
        j = j_search(jmesh({"db": 4}), jnp.asarray(q), jnp.asarray(db), k, metric=metric,
                     n_valid=60, dead=jnp.asarray(dead))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        assert_topk_close(t, j, q, db, metric)
        ids = t[1].numpy()
        assert not np.isin(ids, [5, 17, 33, 57, 60, 61, 62, 63]).any()
        if metric == "L2":
            assert list(ids[0, :2]) == [3, 40]
        live = min(k, 56)
        assert (ids[:, :live] >= 0).all() and (ids[:, live:] == -1).all()


def _merge_by_argmax_passes(parts, k, metric):
    """The merge as it was selected before the sort: the concatenated
    candidates' scores, then min(k, columns) masked-argmax passes, each
    taking the best left, ties to the lowest position."""
    vals = torch.cat([v for v, _ in parts], 1)
    ids = torch.cat([i for _, i in parts], 1)
    scores = torch.where(ids >= 0, -vals if metric == "L2" else vals,
                         torch.full_like(vals, torch.finfo(torch.float32).min))
    cur = scores.clone()
    pos = []
    for _ in range(min(k, vals.shape[1])):
        i = torch.argmax(cur, dim=1, keepdim=True)
        pos.append(i)
        cur.scatter_(1, i, float("-inf"))
    pos = torch.cat(pos, 1)
    out_i = ids.gather(1, pos)
    fill = float("inf") if metric == "L2" else float("-inf")
    return torch.where(out_i >= 0, vals.gather(1, pos), torch.full_like(vals[:, :1], fill)), out_i


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 1000])
def test_merge_shards_selects_as_the_argmax_passes_did(n_shards, metric, k):
    """``merge_shards``'s sort against the argmax passes it replaced, on
    candidates with exact ties within and across shards (a few values
    only, 0 among them), empty slots (id -1 with inf / -inf, as the scan
    gives them) and shards of unequal widths: the same values and ids, bit
    for bit. A valid slot scored -inf (an L2 distance at inf) is where the
    passes went wrong, taking a taken position again once only -inf was
    left; the sort takes each position once."""
    from rag_faiss_embedding_tpu_torch.parallel.sharded import merge_shards

    rng = np.random.default_rng(1000 * n_shards + k + (metric == "IP"))
    fill = float("inf") if metric == "L2" else float("-inf")
    parts = []
    for j in range(n_shards):
        width = 6 + 2 * (j % 3)
        vals = rng.integers(0, 5, (48, width)).astype(np.float32)
        ids = (j * 1000 + rng.permutation(1000)[:width])[None].repeat(48, 0)
        empty = rng.random((48, width)) < 0.2
        vals[empty], ids[empty] = fill, -1
        if j == 0:
            vals[:4], ids[:4] = fill, -1  # rows with a shard left empty
        parts.append((torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int32))))
    got = merge_shards(parts, k, metric, CPU)
    want = _merge_by_argmax_passes(parts, k, metric)
    assert got[1].dtype == torch.int32 and got[0].shape == want[0].shape
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    for v, i in parts:
        v[(torch.rand(v.shape, generator=torch.Generator().manual_seed(k)) < 0.1)
          & (i >= 0)] = fill
    for row in merge_shards(parts, k, metric, CPU)[1].tolist():
        taken = [i for i in row if i >= 0]
        assert len(taken) == len(set(taken))


# ------------------------------------------------------------ ShardedFlatIndex
def _pair(dim, n_dev=4, **kw):
    return (TSharded(dim, tmesh({"db": n_dev}), **kw),
            JSharded(dim, jmesh({"db": n_dev}), **kw))


def test_sharded_index_add_search_reset(rng):
    t, j = _pair(16, n_dev=8, capacity=8192)
    db = rng.standard_normal((500, 16)).astype(np.float32)
    t.add(db)
    j.add(db)
    assert t.ntotal == 500 and t._capacity == j._capacity
    assert int(t.search(db[17], 3)[1][0, 0]) == 17
    more = rng.standard_normal((100, 16)).astype(np.float32)
    t.add(more)
    j.add(more)
    assert int(t.search(more[-1], 1)[1][0, 0]) == 599
    q = rng.standard_normal((4, 16)).astype(np.float32)
    allx = np.concatenate([db, more])
    assert_topk_close(t.search(q, 9), j.search(q, 9), q, allx)
    t.reset()
    assert t.ntotal == 0 and (t.search(q, 2)[1] == -1).all()


def test_grow_on_8_shards_keeps_positions(rng):
    """Growth past capacity moves the shard boundaries; rows keep their
    global positions (the id mapping is positional)."""
    t, j = _pair(16, n_dev=8, capacity=8192)
    cap0 = t._capacity
    db = rng.standard_normal((cap0 + 3000, 16)).astype(np.float32)
    for part in (db[:5000], db[5000:]):
        t.add(part)
        j.add(part)
    assert t._capacity == j._capacity > cap0 and len(t._buf) == 8
    assert all(s.shape[0] == t._capacity // 8 for s in t._buf)
    np.testing.assert_array_equal(t.vectors(), db)
    q = db[::1717]
    ref = numpy_exact(q, db, 5, "L2")
    assert_topk_close(t.search(q, 5), ref, q, db)
    np.testing.assert_array_equal(t.search(q, 5)[1].numpy(), ref[1])
    t.remove_ids([0, 1717, cap0 + 10])
    grown = t._dead is not None
    t.add(rng.standard_normal((9000, 16)).astype(np.float32))  # grows with tombstones
    assert grown and t.ndeleted == 3 and t.nlive == t.ntotal - 3
    assert not np.isin(t.search(q, 5)[1].numpy(), [0, 1717, cap0 + 10]).any()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_remove_ids_and_filter_mask_match_jax(rng, metric):
    t, j = _pair(16, metric=metric)
    db = rng.standard_normal((3000, 16)).astype(np.float32)
    t.add(db)
    j.add(db)
    gone = rng.choice(3000, 900, replace=False)
    assert t.remove_ids(gone) == j.remove_ids(gone) == 900
    assert t.remove_ids(gone[:10]) == 0 and t.nlive == j.nlive == 2100
    q = np.concatenate([db[gone[:3]], rng.standard_normal((5, 16)).astype(np.float32)])
    keep = rng.random(3000) < 0.5
    for kw in ({}, {"filter_mask": keep}):
        tout = t.search(q, 12, **kw)
        jout = j.search(q, 12, **kw)
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        assert_topk_close(tout, jout, q, db, metric)
        ids = tout[1].numpy()
        assert not np.isin(ids, gone).any()
        if kw:
            assert keep[ids[ids >= 0]].all()
    with pytest.raises(ValueError, match="filter_mask"):
        t.search(q, 3, filter_mask=keep[:10])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_round_trips_and_cross_loads(rng, tmp_path, dtype):
    """f32 and bf16 states through both stores: the port's save loads in
    JAX and JAX's in the port (onto 4 and 2 shards), bit for bit in the
    stored rows, with the same searches."""
    db = rng.standard_normal((256, 16)).astype(np.float32)
    doc_ids = list(range(1000, 1256))
    stores = {}
    for name, store_cls, index, kw in (
            ("t", TStore, TSharded(16, tmesh({"db": 4}), dtype=dtype), {"device": "cpu"}),
            ("j", JStore, JSharded(16, jmesh({"db": 4}), dtype=dtype), {})):
        s = store_cls(dimension=16, index_path=tmp_path / f"{name}.idx", index=index, **kw)
        s.add_vectors(db, doc_ids)
        s.remove_doc_ids([1003, 1200])
        s.save_index()
        stores[name] = s
    ts, js = (dict(np.load(tmp_path / f"{n}.idx")) for n in "tj")
    assert sorted(ts) == sorted(js)
    for key in ts:
        assert ts[key].dtype == js[key].dtype, key
        np.testing.assert_array_equal(ts[key], js[key])
    q = db[5:9] + 0.01
    rv, ri = stores["j"].search(q, k=4)
    for mesh in (tmesh({"db": 4}), tmesh({"db": 2})):
        t_from_j = TStore(dimension=16, index_path=tmp_path / "j.idx", mesh=mesh, device="cpu")
        assert isinstance(t_from_j.index, TSharded) and t_from_j.index.n_dev == mesh.size
        assert t_from_j.nlive == 254 and t_from_j.index.dtype_name == dtype
        np.testing.assert_array_equal(t_from_j.index.vectors(), stores["j"].index.vectors()
                                      .astype(np.float32))
        tv, ti = t_from_j.search(q, k=4)
        assert ti == ri and all(1003 not in row for row in ti)
        for a, b in zip(tv, rv):
            np.testing.assert_allclose(a, b, rtol=0, atol=value_tol(q, db))
    j_from_t = JStore(dimension=16, index_path=tmp_path / "t.idx", mesh=jmesh({"db": 4}))
    assert isinstance(j_from_t.index, JSharded) and j_from_t.nlive == 254
    assert j_from_t.search(q, k=4)[1] == ri


def test_loads_without_explicit_mesh(rng, tmp_path):
    """No mesh: a CPU store loads the sharded file onto one CPU shard (JAX's
    store takes all its devices; the port's CUDA store takes every card)."""
    db = rng.standard_normal((64, 8)).astype(np.float32)
    store = JStore(dimension=8, index_path=tmp_path / "s2.idx",
                   index=JSharded(8, jmesh({"db": 2})))
    store.add_vectors(db, list(range(64)))
    store.save_index()
    loaded = TStore(dimension=8, index_path=tmp_path / "s2.idx", device="cpu")
    assert isinstance(loaded.index, TSharded) and loaded.index.n_dev == 1
    assert loaded.index.devices == [CPU]
    assert loaded.search(db[3], k=1)[1] == [3]
    assert loaded.search(db[:5], k=2)[1] == JStore(
        dimension=8, index_path=tmp_path / "s2.idx").search(db[:5], k=2)[1]


def test_bad_arguments_raise():
    m = tmesh({"db": 4})
    with pytest.raises(ValueError, match="metric"):
        TSharded(8, m, metric="cos")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TSharded(8, m, dtype="int8")
    with pytest.raises(ValueError, match="must divide"):
        t_search(m, np.zeros((1, 8), np.float32), np.zeros((10, 8), np.float32), 2)
    idx = TSharded(8, m)
    with pytest.raises(ValueError, match="expected dim"):
        idx.add(np.zeros((2, 4), np.float32))


# --------------------------------------------------------------- the slice
def test_query_engine_serves_a_jax_saved_sharded_ivf_file(tmp_path):
    """Both managers ingest the slice's 40 documents with one vocabulary and
    one set of encoder weights; a JAX ``ShardedIVFIndex`` (4 devices, 4
    lists, one streamed document) over the JAX manager's embeddings is saved
    by the JAX store. The port's ``QueryEngine`` over
    ``VectorStore(mesh=<4 CPU shards>)`` loading that file answers every
    request as the JAX engine over the same file does: the same documents
    in the same order, scores to rtol 1e-4 / atol 1e-3 (the encoders agree
    to ~1e-5 per element)."""
    from rag_faiss_embedding_tpu.core import Config as JCfg
    from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
    from rag_faiss_embedding_tpu.models import convert as jconvert
    from rag_faiss_embedding_tpu.models.generator import AnswerGenerator as JGen
    from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer
    from rag_faiss_embedding_tpu.parallel.sharded_ivf import ShardedIVFIndex as JSIVF
    from rag_faiss_embedding_tpu.rag import QueryEngine as JEngine
    from rag_faiss_embedding_tpu.rag import RAGManager as JManager
    from rag_faiss_embedding_tpu_torch.core import Config as TCfg
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator as TGen
    from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex as TSIVF
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
    from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

    from .test_torch_slice import WIDTHS, _documents

    docs = _documents(tmp_path)
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    managers = {}
    for name, cls, cfg_cls, kw in (("jax", JManager, JCfg, {}),
                                   ("torch", TManager, TCfg, {"device": "cpu"})):
        data = tmp_path / name / "data"
        tok.save(data / "vocab.txt")
        jconvert.export_params(params, data / "encoder_params.npz")
        m = cls(config=cfg_cls(base_dir=tmp_path / name, model_name="offline-test"), **kw)
        assert m.initialize_database(docs) == 40
        managers[name] = m
    jm, tm = managers["jax"], managers["torch"]
    vecs = jm.vector_store.index.vectors()
    store = JStore(dimension=vecs.shape[1], index_path=tmp_path / "sharded.idx",
                   index=JSIVF(vecs.shape[1], jmesh({"db": 4}), nlist=4, nprobe=2,
                               train_iters=8))
    store.add_vectors(vecs[:39], jm.vector_store.doc_ids[:39])
    store.add_vectors(vecs[39:], jm.vector_store.doc_ids[39:])  # the stream tier
    store.save_index()

    j_engine = JEngine(jm.db, JStore(index_path=tmp_path / "sharded.idx",
                                     mesh=jmesh({"db": 4})),
                       jm.embedder, generator=JGen(backend="extractive"))
    t_store = TStore(index_path=tmp_path / "sharded.idx", mesh=tmesh({"db": 4}), device="cpu")
    assert isinstance(t_store.index, TSIVF) and t_store.index.n_dev == 4
    t_engine = TEngine(tm.db, t_store, tm.embedder, generator=TGen(backend="extractive"))
    texts = [d["content"] for d in docs[::4]] + ["tensor cores", "index sharding"]
    for text in texts:
        t_hits, j_hits = t_engine.search(text, top_k=5), j_engine.search(text, top_k=5)
        assert [h["id"] for h in t_hits] == [h["id"] for h in j_hits] and len(t_hits) == 5
        np.testing.assert_allclose([h["score"] for h in t_hits],
                                   [h["score"] for h in j_hits], rtol=1e-4, atol=1e-3)
    assert [r[0]["id"] for r in t_engine.search_batch(texts[:6], top_k=3)] == \
        [r[0]["id"] for r in j_engine.search_batch(texts[:6], top_k=3)]

    # the managers' writes on the sharded file: a re-added url replaces its
    # document (the old vector tombstoned), a new one streams in, a delete
    # tombstones; both packages then answer alike
    jm.vector_store = JStore(index_path=tmp_path / "sharded.idx", mesh=jmesh({"db": 4}))
    tm.vector_store = TStore(index_path=tmp_path / "sharded.idx", mesh=tmesh({"db": 4}),
                             device="cpu")
    new = [dict(docs[5], content="index sharding over four cards, merged by top-k"),
           {"url": "https://synthetic.example/new", "title": "new",
            "content": "tensor cores scan the shards"}]
    for m in (jm, tm):
        assert m.add_documents(new) == 2
        assert m.delete_documents(doc_ids=[docs[2]["id"]]) == 1
    assert tm.vector_store.nlive == jm.vector_store.nlive == 40
    assert tm.vector_store.doc_ids == jm.vector_store.doc_ids
    for text in texts[:4] + [new[0]["content"], new[1]["content"]]:
        t_hits = tm.search_similar_documents(text, k=4)
        j_hits = jm.search_similar_documents(text, k=4)
        assert [h["id"] for h in t_hits] == [h["id"] for h in j_hits]
        assert docs[2]["id"] not in [h["id"] for h in t_hits]
    for m in managers.values():
        m.cleanup()
