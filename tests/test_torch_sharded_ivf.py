"""The sharded IVF (parallel/sharded_ivf.py), port vs the JAX package.

JAX's ``ShardedIVFIndex`` runs on ``make_mesh({"db": 4})`` over conftest's 8
virtual CPU devices, the port's on four ``cpu`` devices; every search runs
the kernels' plain versions (``backend="pallas"``: ``union_scan_reference``,
held to JAX's interpret-mode kernel). Where both packages build, the
centroids (and PQ codebooks) are pinned on both, since their k-means RNGs
differ; otherwise a JAX-built index is cross-loaded through the npz state.
Inputs come from a seeded numpy generator at the JAX tests' sizes (dim 16;
dim 128 for the union-scan case). Tolerance: ids equal except at near-ties,
values within rtol 1e-5 x (max ||q||^2 + max ||x||^2); int8 codes and
scales bit-exact; states array for array (norms to float32 rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rag_faiss_embedding_tpu.core.mesh import make_mesh as jmesh
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.parallel.sharded_ivf import ShardedIVFIndex as JS
from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.parallel import sharded_ivf as siv
from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex as TS

from .test_distance import numpy_exact
from .test_ivf import clustered_data
from .test_torch_sharded import assert_topk_close

CPU = torch.device("cpu")


def tmesh(n):
    return make_mesh({"db": n}, devices=[CPU] * n)


def _state(idx):
    return {k: np.asarray(v) for k, v in idx.state_dict().items()}


def assert_states_equal(t_state, j_state):
    """Array for array: integers and codes exact, float arrays to float32
    rounding (the two packages sum squared norms in different orders)."""
    assert sorted(t_state) == sorted(j_state)
    for key in j_state:
        a, b = np.asarray(t_state[key]), np.asarray(j_state[key])
        assert a.shape == b.shape, key
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=key)


def skewed(rng):
    """640 rows on list 0 of 8 pinned centroids: the window cap spills."""
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 5
    big = rng.standard_normal((600, 16)).astype(np.float32) * 0.05 + centers[0]
    rest = (centers[None] + 0.05 * rng.standard_normal((40, 8, 16))
            ).reshape(-1, 16).astype(np.float32)
    return np.concatenate([big, rest]), centers


def pinned_pair(centers, n_dev=4, quantile=None, **kw):
    t = TS(centers.shape[1], tmesh(n_dev), nlist=len(centers), train_iters=8, **kw)
    j = JS(centers.shape[1], jmesh({"db": n_dev}), nlist=len(centers), train_iters=8, **kw)
    t.centroids = torch.tensor(centers)
    j.centroids = jnp.asarray(centers)
    if quantile is not None:
        t.window_quantile = j.window_quantile = quantile
    return t, j


def assert_search_same(t, j, q, k, x, metric="L2", **kw):
    tout, jout = t.search(q, k, **kw), j.search(q, k, **kw)
    assert tout[1].dtype == torch.int32 and tout[0].shape == (len(q), k)
    assert_topk_close(tout, jout, q, x, metric)
    return tout[1].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_gives_jax_layout_slot_for_slot(rng, dtype):
    """With the centroids pinned, the port's build lays every shard out as
    JAX's does: the same slots, ids, codes (int8 codes and scales bit for
    bit), spill tier and window; the searches agree."""
    pts, centers = skewed(rng)
    t, j = pinned_pair(centers, quantile=0.5, nprobe=8, dtype=dtype)
    t.build(pts)
    j.build(pts)
    assert t._window == j._window == 128 and t._spill is not None
    np.testing.assert_array_equal(np.stack([s.numpy() for s in t._ids]), np.asarray(j._ids))
    codes = np.stack([s.float().numpy() for s in t._vecs])
    np.testing.assert_array_equal(codes, np.asarray(j._vecs).astype(np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(np.stack([s.numpy() for s in t._scales]),
                                      np.asarray(j._scales))
    np.testing.assert_array_equal(np.stack([s.numpy() for s in t._spill[2]]),
                                  np.asarray(j._spill[2]))
    assert t._spill[3] == np.asarray(j._spill[3])[:, 0].tolist()
    assert_states_equal(_state(t), _state(j))
    q = rng.standard_normal((6, 16)).astype(np.float32)
    for nprobe in (1, 8):
        assert_search_same(t, j, q, 7, pts, nprobe=nprobe)
    if dtype == "float32":  # full probe + the spill tier: exact
        np.testing.assert_array_equal(t.search(q, 7)[1].numpy(),
                                      numpy_exact(q, pts, 7, "L2")[1])


def test_streaming_add_remove_and_rebuild_match_jax(rng):
    pts, centers = clustered_data(rng, n_clusters=8, per_cluster=32)
    t, j = pinned_pair(centers, nprobe=8)
    for idx in (t, j):
        idx.build(pts[:200])
        idx.add(pts[200:220])  # below the threshold: pending tier
    assert t.ntotal == 220 and len(t._stream_ids) == 20
    assert int(t.search(pts[210], 1)[1][0, 0]) == 210  # found at once (exact scan)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    assert_search_same(t, j, q, 5, pts, nprobe=2)
    gone = [3, 150, 205, 219]
    assert t.remove_ids(gone) == j.remove_ids(gone) == 4
    assert t.nlive == j.nlive == 216
    assert_search_same(t, j, pts[gone], 3, pts, nprobe=8)
    assert_states_equal(_state(t), _state(j))
    for idx in (t, j):
        idx.add(pts[220:])  # past the threshold: rebuild
    assert len(t._stream_ids) == 0 and t._n_built == j._n_built == 252
    assert int(t.search(pts[240], 1)[1][0, 0]) == 240
    ids = assert_search_same(t, j, q, 5, pts, nprobe=8)
    assert not np.isin(ids, gone).any()
    assert_states_equal(_state(t), _state(j))


def test_filter_mask_matches_jax(rng):
    pts, centers = skewed(rng)
    t, j = pinned_pair(centers, quantile=0.5, nprobe=4)
    extra = rng.standard_normal((9, 16)).astype(np.float32)
    for idx in (t, j):
        idx.build(pts)
        idx.add(extra)
    allx = np.concatenate([pts, extra])
    keep = rng.random(len(allx)) < 0.6
    q = np.concatenate([allx[::150], extra[:2]])
    ids = assert_search_same(t, j, q, 6, allx, filter_mask=keep, nprobe=8)
    assert keep[ids[ids >= 0]].all()
    with pytest.raises(ValueError, match="filter_mask"):
        t.search(q, 3, filter_mask=keep[:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_cross_loads_both_ways(rng, tmp_path, dtype):
    """A JAX-trained index (its own k-means) saved by the JAX store loads in
    the port's store and searches the same; the port's re-save loads in
    JAX's store again, bit for bit in the stored rows."""
    pts, _ = clustered_data(rng, n_clusters=4, per_cluster=32)
    jidx = JS(16, jmesh({"db": 4}), nlist=4, nprobe=4, train_iters=8, dtype=dtype)
    store = JStore(dimension=16, index_path=tmp_path / "j.idx", index=jidx)
    store.add_vectors(pts, list(range(500, 500 + len(pts))))
    store.add_vectors(pts[:3] + 0.5, [900, 901, 902])  # the stream tier
    store.save_index()
    t_store = TStore(dimension=16, index_path=tmp_path / "j.idx", mesh=tmesh(4), device="cpu")
    assert isinstance(t_store.index, TS) and t_store.doc_ids == store.doc_ids
    assert len(t_store.index._stream_ids) == 3
    q = pts[::9] + 0.01
    (td, ti), (jd, ji) = t_store.search(q, k=4), store.search(q, k=4)
    assert ti == ji and (dtype == "bfloat16" or ti[0][0] == 500)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    t_store.save_index(tmp_path / "t.idx")
    assert_states_equal(dict(np.load(tmp_path / "t.idx")), dict(np.load(tmp_path / "j.idx")))
    back = JStore(dimension=16, index_path=tmp_path / "t.idx", mesh=jmesh({"db": 4}))
    assert back.search(q, k=4)[1] == ji


def test_int8_storage_and_bit_exact_reload(rng):
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=48, spread=0.5)
    jidx = JS(16, jmesh({"db": 4}), nlist=8, nprobe=8, train_iters=8, dtype="int8")
    jidx.build(pts)
    t = TS.from_state_dict(_state(jidx), mesh=tmesh(4))
    assert t.quantized and t.recall_target == jidx.recall_target
    for a, b in ((t._ids, jidx._ids), (t._vecs, jidx._vecs), (t._scales, jidx._scales)):
        np.testing.assert_array_equal(np.stack([s.numpy() for s in a]), np.asarray(b))
    q = rng.standard_normal((16, 16)).astype(np.float32)
    assert_search_same(t, jidx, q, 10, pts, nprobe=8)
    _, ref = numpy_exact(q, pts, 10, "L2")
    got = t.search(q, 10)[1].numpy()
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, ref)]) >= 0.95
    again = TS.from_state_dict(_state(t), mesh=tmesh(4))
    for a, b in ((again._vecs, t._vecs), (again._scales, t._scales)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    v1, i1 = t.search(q, 5)
    v2, i2 = again.search(q, 5)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    extra = rng.standard_normal((5, 16)).astype(np.float32)
    t.add(extra)  # the pending tier stays bf16: the streamed row is found
    assert int(t.search(extra[2], 1)[1][0, 0]) == len(pts) + 2
    np.testing.assert_allclose(t.vectors(), np.concatenate([pts, extra]), atol=0.05, rtol=0.1)


def test_ip_metric_matches_jax(rng):
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=32, spread=0.2)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    jidx = JS(16, jmesh({"db": 4}), nlist=8, nprobe=8, metric="IP", train_iters=12)
    jidx.build(pts)
    t = TS.from_state_dict(_state(jidx), mesh=tmesh(4))
    q = pts[::7] + 0.03 * rng.standard_normal((len(pts[::7]), 16)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    for nprobe in (2, 8):
        ids = assert_search_same(t, jidx, q, 5, pts, metric="IP", nprobe=nprobe)
    np.testing.assert_array_equal(ids, numpy_exact(q, pts, 5, "IP")[1])
    vals = t.search(q, 5)[0].numpy()
    assert (np.diff(vals, axis=1) <= 1e-6).all()  # IP descends
    extra = rng.standard_normal((3, 16)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    t.add(extra)
    jidx.add(extra)
    assert int(t.search(extra[1], 1)[1][0, 0]) == len(pts) + 1
    assert_search_same(t, jidx, extra, 3, np.concatenate([pts, extra]), metric="IP")
    # the port's own build (spherical k-means) serves IP too
    own = TS(16, tmesh(4), nlist=8, nprobe=8, metric="IP", train_iters=12)
    own.build(pts)
    np.testing.assert_allclose(own.centroids.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(own.search(q, 5, nprobe=8)[1].numpy(),
                                  numpy_exact(q, pts, 5, "IP")[1])


def test_ivf_pq_matches_jax(rng):
    """IVF-PQ: a JAX-built index (its own codebooks) loads and searches the
    same through the decode kernel's plain version; the port's build on
    JAX's centroids and codebooks gives JAX's codes (but at near-tie
    codewords) and reconstructs in insertion order."""
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=48, spread=0.3)
    jidx = JS(16, jmesh({"db": 4}), nlist=8, nprobe=8, train_iters=6, pq_m=4, pq_ksub=16)
    jidx.build(pts)
    t = TS.from_state_dict(_state(jidx), mesh=tmesh(4))
    assert t.pq_m == 4 and t.dtype == torch.uint8 and t._tier_dtype == torch.bfloat16
    q = pts[::11] + 0.02
    for backend in ("auto", "xla", "pallas"):
        t.backend = jidx.backend = backend
        assert_search_same(t, jidx, q, 6, pts, nprobe=4)
    np.testing.assert_allclose(t.vectors(), np.asarray(jidx.vectors()), rtol=1e-6, atol=1e-6)
    own = TS(16, tmesh(4), nlist=8, nprobe=8, train_iters=6, pq_m=4, pq_ksub=16)
    own.centroids = t.centroids.clone()
    own.pq_codebooks = t.pq_codebooks.clone()
    own.build(pts)
    assert own._window == jidx._window
    np.testing.assert_array_equal(np.stack([s.numpy() for s in own._ids]),
                                  np.asarray(jidx._ids))
    same = np.stack([s.numpy() for s in own._vecs]) == np.asarray(jidx._vecs)
    assert same.mean() > 0.999
    assert_search_same(own, jidx, q, 6, pts, nprobe=8)


def test_lossless_reload_is_not_a_rebuild(rng, monkeypatch):
    """A reload re-scatters the saved rows (no assignment, no build), spill
    and stream tiers included, and searches bit for bit the same."""
    pts, centers = skewed(rng)
    t, _ = pinned_pair(centers, quantile=0.5, nprobe=8)
    t.build(pts)
    t.add(rng.standard_normal((5, 16)).astype(np.float32))
    assert t._spill is not None and len(t._stream_ids) == 5
    q = rng.standard_normal((6, 16)).astype(np.float32)
    v1, i1 = t.search(q, 7)
    state = t.state_dict()

    def boom(*a, **k):
        raise AssertionError("a reload must not assign or build")

    monkeypatch.setattr(siv, "kmeans_assign", boom)
    monkeypatch.setattr(siv, "train_kmeans", boom)
    monkeypatch.setattr(TS, "build", boom)
    loaded = TS.from_state_dict(state, mesh=tmesh(4))
    assert loaded._window == t._window
    v2, i2 = loaded.search(q, 7)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


def test_reload_from_4_shards_onto_2_matches_jax(rng):
    """Both packages re-stripe a 4-shard save onto 2 shards by global id:
    the same slots, and the searches of the 4-shard index."""
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=32)
    jidx = JS(16, jmesh({"db": 4}), nlist=8, nprobe=8, train_iters=8)
    jidx.build(pts)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _, i4 = jidx.search(q, 5, nprobe=8)
    t2 = TS.from_state_dict(_state(jidx), mesh=tmesh(2))
    j2 = JS.from_state_dict(_state(jidx), mesh=jmesh({"db": 2}))
    assert t2.n_dev == 2 and t2._window == j2._window
    np.testing.assert_array_equal(np.stack([s.numpy() for s in t2._ids]), np.asarray(j2._ids))
    np.testing.assert_array_equal(t2.search(q, 5, nprobe=8)[1].numpy(), np.asarray(i4))
    assert_search_same(t2, j2, q, 5, pts, nprobe=3)
    # and the port's 2-shard save loads onto JAX's 4
    j4 = JS.from_state_dict(_state(t2), mesh=jmesh({"db": 4}))
    np.testing.assert_array_equal(np.asarray(j4.search(q, 5, nprobe=8)[1]), np.asarray(i4))


def test_vectors_insertion_order_and_reset(rng):
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=32)
    idx = TS(16, tmesh(4), nlist=8, train_iters=8)
    idx.window_quantile = 0.5  # spills: no row may count twice
    idx.build(pts[:220])
    extra = rng.standard_normal((7, 16)).astype(np.float32)
    idx.add(extra)
    vecs, ids = idx.vectors(return_ids=True)
    np.testing.assert_allclose(vecs, np.concatenate([pts[:220], extra]), rtol=1e-6)
    np.testing.assert_array_equal(ids, np.arange(227))
    idx.reset()
    assert idx.ntotal == 0 and idx._vecs is None and idx._spill is None
    assert (idx.search(pts[:2], 3)[1] == -1).all()
    idx.build(pts)  # rebuildable after reset
    assert int(idx.search(pts[3], 1, nprobe=8)[1][0, 0]) == 3


def test_union_scan_route_on_cpu_matches_jax_interpret(rng, monkeypatch):
    """``backend="pallas"`` on a CPU mesh runs the union scan's plain
    version on every shard, held to JAX's interpret-mode kernel on the same
    state (dim 128: the kernel's alignment)."""
    pts, _ = clustered_data(rng, n_clusters=8, per_cluster=64)
    pts = np.tile(pts, (1, 8)).astype(np.float32)
    jidx = JS(128, jmesh({"db": 4}), nlist=8, nprobe=8, train_iters=8)
    jidx.build(pts)
    t = TS.from_state_dict(_state(jidx), mesh=tmesh(4))
    q = rng.standard_normal((16, 128)).astype(np.float32)
    calls = []
    real = siv.fused_ivf_search_math
    monkeypatch.setattr(siv, "fused_ivf_search_math",
                        lambda *a, **kw: calls.append(kw["backend"]) or real(*a, **kw))
    for backend in ("xla", "pallas"):
        t.backend = jidx.backend = backend
        assert_search_same(t, jidx, q, 5, pts, nprobe=8)
    t.backend = "auto"  # a CPU mesh: the plain chunk body, as JAX's
    t.search(q, 5)
    assert calls == ["xla"] * 4 + ["pallas"] * 4 + ["xla"] * 4
