"""The out-of-memory IVF build (``IVFFlatIndex.build_chunked``) in the port vs
the JAX package.

First the JAX package's own build_chunked tests (tests/test_pq.py), on the
port: a chunked build with training pinned to a dense build's equals the
dense build, the refine shadow is compact, and ``balance="reassign"``
tightens the window. Then each storage (IVF-PQ at f32 compute, with no
refine, a bf16 and an int8 one; int8 without rerank; bf16; f32) under both
balance modes is built by both packages from one recording ``source`` over
rows that a chunk size of 300 does not divide. The port's build is pinned to
the JAX build's centroids and codebooks (the k-means RNGs differ,
tests/test_torch_kmeans.py), and the two are held slot for slot: window,
spill count, lengths, ids, codes and scales on live slots, the pending tier,
norms to rtol 1e-6; searches give values to rtol 1e-5 of themselves and of
the terms a distance cancels, and equal ids but at ties within that (the
port-vs-JAX tolerance of tests/test_torch_pq.py; within one package the JAX
tests' rtol / atol 1e-5 and equal ids hold, and the port's chunked-vs-dense
tests keep them). Unpinned, both packages call ``source`` with
the same ``(start, size)`` list. Then each index is saved, loaded by the
other package, rows are removed in both, and the searches agree.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index.ivf import IVFFlatIndex as JIVF
from rag_faiss_embedding_tpu_torch.index.ivf import IVFFlatIndex as TIVF

D = 64
N, CHUNK = 1536, 300  # five chunks, the last one short
RTOL = ATOL = 1e-5


def clustered(seed=0, n_clusters=16, per=96, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, D)).astype(np.float32) * 3
    pts = (centers[:, None] + spread * rng.standard_normal((n_clusters, per, D))
           ).reshape(-1, D).astype(np.float32)
    q = (pts[rng.choice(len(pts), 16, replace=False)]
         + 0.05 * rng.standard_normal((16, D))).astype(np.float32)
    return pts, q


class Source:
    """``source(start, size)`` over fixed rows, recording its calls."""

    def __init__(self, rows):
        self.rows, self.calls = rows, []

    def __call__(self, start, size):
        self.calls.append((start, size))
        return self.rows[start:start + size]


def _n(x):
    """Host numpy copy of a tensor or JAX array; bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


# ----------------------------------------------- the JAX tests, on the port
def test_ivfpq_build_chunked_matches_dense_build():
    """tests/test_pq.py::test_ivfpq_build_chunked_matches_dense_build."""
    pts, q = clustered(per=64)
    dense = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", device="cpu")
    dense.build(pts)
    v1, i1 = dense.search(q, 10, nprobe=8)
    chunked = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", device="cpu")
    chunked.centroids, chunked.is_trained = dense.centroids, True
    chunked.pq_codebooks = dense.pq_codebooks
    chunked.build_chunked(lambda s, z: pts[s:s + z], n=len(pts), chunk_size=300)
    assert chunked._window == dense._window and chunked._n_spill == dense._n_spill
    np.testing.assert_array_equal(_n(chunked._sorted_ids), _n(dense._sorted_ids))
    np.testing.assert_array_equal(_n(chunked._sorted_vecs), _n(dense._sorted_vecs))
    v2, i2 = chunked.search(q, 10, nprobe=8)
    np.testing.assert_array_equal(_n(i1), _n(i2))
    np.testing.assert_allclose(_n(v1), _n(v2), rtol=RTOL, atol=ATOL)
    # the self-trained path, end to end
    auto = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", device="cpu")
    auto.build_chunked(lambda s, z: pts[s:s + z], n=len(pts), chunk_size=512)
    _, ids = auto.search(pts[:8], 1, nprobe=8)
    assert (_n(ids)[:, 0] == np.arange(8)).mean() >= 0.75
    assert set(auto.build_stats) >= {"train_s", "assign_s", "encode_s", "finalize_s",
                                     "total_s"}


def test_int8_build_chunked_matches_dense_build():
    """tests/test_pq.py::test_int8_build_chunked_matches_dense_build."""
    pts, q = clustered(per=64)
    dense = TIVF(D, nlist=8, nprobe=8, dtype="int8", rerank=False, device="cpu")
    dense.build(pts)
    v1, i1 = dense.search(q, 10, nprobe=8)
    chunked = TIVF(D, nlist=8, nprobe=8, dtype="int8", rerank=False, device="cpu")
    chunked.centroids, chunked.is_trained = dense.centroids, True
    chunked.build_chunked(lambda s, z: pts[s:s + z], n=len(pts), chunk_size=300)
    assert chunked._window == dense._window
    np.testing.assert_array_equal(_n(chunked._sorted_ids), _n(dense._sorted_ids))
    np.testing.assert_array_equal(_n(chunked._sorted_scales), _n(dense._sorted_scales))
    v2, i2 = chunked.search(q, 10, nprobe=8)
    np.testing.assert_array_equal(_n(i1), _n(i2))
    np.testing.assert_allclose(_n(v1), _n(v2), rtol=RTOL, atol=ATOL)
    # int8 with its rerank shadow is refused (footprint); dense bf16 builds
    with pytest.raises(ValueError, match="rerank=False"):
        TIVF(D, nlist=8, dtype="int8", device="cpu").build_chunked(
            lambda s, z: pts[s:s + z], n=len(pts))
    bf = TIVF(D, nlist=8, nprobe=8, dtype="bfloat16", device="cpu")
    bf.centroids, bf.is_trained = dense.centroids, True
    bf.build_chunked(lambda s, z: pts[s:s + z], n=len(pts), chunk_size=300)
    _, ids = bf.search(pts[:4], 1, nprobe=8)
    assert (_n(ids)[:, 0] == np.arange(4)).all()


def test_ivfpq_refine_shadow_is_compact():
    """tests/test_pq.py::test_ivfpq_refine_shadow_is_compact, chunked part.
    The slot -> row map holds the ids (corpus positions), as JAX's alias
    does, but in its own tensor: ``remove_ids`` writes -1 into the ids in
    place, and the map must keep the built layout, as JAX's immutable one
    does."""
    pts, _ = clustered(per=96, spread=0.25)
    n = len(pts)
    idx = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", rerank=True,
               rerank_depth=32, refine_dtype="bfloat16", device="cpu")
    idx.build_chunked(lambda s, z: pts[s:s + z], n=n, chunk_size=512)
    assert idx._sorted_shadow.shape == (n, D)
    assert idx._shadow_pos.shape == ((idx.nlist + 1) * idx._window,)
    np.testing.assert_array_equal(_n(idx._shadow_pos), _n(idx._sorted_ids))
    np.testing.assert_allclose(_n(idx._sorted_shadow), pts, rtol=0.01, atol=0.01)
    assert set(idx.build_stats) >= {"shadow_s", "total_s"}
    built = _n(idx._shadow_pos).copy()
    idx.remove_ids([0, 5])
    np.testing.assert_array_equal(_n(idx._shadow_pos), built)
    loaded = TIVF.from_state_dict(idx.state_dict(), device="cpu")
    assert loaded._sorted_shadow.shape == (loaded._n_built, D)
    v, ids = idx.vectors(return_ids=True)
    lv, lids = loaded.vectors(return_ids=True)
    np.testing.assert_array_equal(ids, lids)
    np.testing.assert_array_equal(v, lv)


def test_build_chunked_balanced_window_compression():
    """tests/test_pq.py::test_build_chunked_balanced_window_compression."""
    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, 33) ** 0.8
    w /= w.sum()
    centers = rng.standard_normal((32, 64)).astype(np.float32)
    n = 8192
    rows = (centers[rng.choice(32, n, p=w)]
            + 0.2 * rng.standard_normal((n, 64)).astype(np.float32))
    built = {}
    for bal in ("spill", "reassign"):
        idx = TIVF(64, nlist=32, nprobe=32, train_iters=4, pq_m=8, pq_compute="f32",
                   balance=bal, rerank=True, rerank_depth=64, refine_dtype="bfloat16",
                   device="cpu")
        if bal == "reassign":
            idx.cap_factor = 1.5
        idx.build_chunked(lambda s, z: rows[s:s + z], n=n, chunk_size=2048)
        built[bal] = idx
        assert idx.ntotal == n
    assert built["reassign"]._window < built["spill"]._window
    q = rows[:16] + 0.05 * rng.standard_normal((16, 64)).astype(np.float32)
    d = ((q[:, None, :].astype(np.float64) - rows[None].astype(np.float64)) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :10]
    _, pred = built["reassign"].search(q, 10, nprobe=32)
    hits = sum(len(set(p.tolist()) & set(t.tolist())) for p, t in zip(_n(pred), truth))
    assert hits / truth.size > 0.7


# ------------------------------------------------------- port against JAX
PQ = dict(pq_m=16, pq_compute="f32")
CONFIGS = {
    "pq": PQ,
    "pq_refine_bf16": dict(PQ, rerank=True, rerank_depth=32, refine_dtype="bfloat16"),
    "pq_refine_int8": dict(PQ, rerank=True, rerank_depth=32),
    "pq_reassign": dict(PQ, balance="reassign", reassign_choices=2),
    "int8": dict(dtype="int8", rerank=False),
    "bf16": dict(dtype="bfloat16"),
    "f32_reassign": dict(dtype="float32", balance="reassign", reassign_choices=2),
}


_PTS, _Q = clustered()
# max ||q||^2 + max ||x||^2: the scale of the float32 terms a distance cancels
CANCELLED = float((_Q.astype(np.float64) ** 2).sum(1).max()
                  + (_PTS.astype(np.float64) ** 2).sum(1).max())


def _make(cls, kw, **dev):
    idx = cls(D, nlist=8, nprobe=8, train_iters=5, **kw, **dev)
    # tight windows, so rows spill to the pending tier in both modes
    idx.window_quantile, idx.cap_factor = 0.5, 1.0
    return idx


_BUILT = {}


def _built(name):
    """(JAX index, its calls, the port index pinned to its training, the
    port's calls unpinned, the unpinned port index); module cache."""
    if name not in _BUILT:
        pts, _ = clustered()
        js = Source(pts)
        jidx = _make(JIVF, CONFIGS[name])
        jidx.build_chunked(js, n=N, chunk_size=CHUNK)
        free_src = Source(pts)
        free = _make(TIVF, CONFIGS[name], device="cpu")
        free.build_chunked(free_src, n=N, chunk_size=CHUNK)
        tidx = _make(TIVF, CONFIGS[name], device="cpu")
        tidx.centroids = torch.from_numpy(np.array(jidx.centroids))
        tidx.is_trained = True
        if jidx.pq_codebooks is not None:
            tidx.pq_codebooks = torch.from_numpy(np.array(jidx.pq_codebooks))
        ts = Source(pts)
        tidx.build_chunked(ts, n=N, chunk_size=CHUNK)
        _BUILT[name] = (jidx, js.calls, tidx, ts.calls, free_src.calls, free)
    return _BUILT[name]


def _agree(t_out, j_out):
    """Values to rtol 1e-5 of themselves and of the terms that cancel in
    ||q||^2 - 2 q.x + ||x||^2 (the two packages sum in other orders; the
    rows' norms are ~580 here); ids equal but where two values tie within
    that."""
    tv, ti = (_n(x) for x in t_out)
    jv, ji = (_n(x) for x in j_out)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_array_equal(ti < 0, ~fin)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=RTOL * CANCELLED)
    diff = ti != ji
    assert diff.mean() <= 0.02
    np.testing.assert_allclose(tv[diff], jv[diff], rtol=RTOL, atol=RTOL * CANCELLED)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_build_chunked_equals_jax_slot_for_slot(name):
    jidx, _, tidx, tcalls, _, _ = _built(name)
    assert tidx._window == jidx._window and tidx._n_spill == jidx._n_spill
    assert tidx._n_spill > 0  # the pending tier is exercised
    assert (tidx.ntotal, tidx._n_built, tidx.ndeleted) == (jidx.ntotal, jidx._n_built, 0)
    assert tcalls == [(s, min(CHUNK, N - s)) for s in range(0, N, CHUNK)] * (
        3 if tidx.rerank and tidx.pq_m else 2)
    np.testing.assert_array_equal(_n(tidx._lengths), _n(jidx._lengths))
    ids = _n(jidx._sorted_ids)
    np.testing.assert_array_equal(_n(tidx._sorted_ids), ids)
    live = ids >= 0
    codes = _n(tidx._sorted_vecs)
    np.testing.assert_array_equal(codes[live], _n(jidx._sorted_vecs)[live])
    assert not codes[~live].any()  # dead slots stay zero
    np.testing.assert_allclose(_n(tidx._sorted_sq)[live], _n(jidx._sorted_sq)[live],
                               rtol=1e-6)
    if tidx.quantized:
        np.testing.assert_array_equal(_n(tidx._sorted_scales)[live],
                                      _n(jidx._sorted_scales)[live])
    np.testing.assert_array_equal(tidx._pending_rowids, jidx._pending_rowids)
    np.testing.assert_array_equal(tidx._pending.vectors(), jidx._pending.vectors())
    if tidx.rerank:
        np.testing.assert_array_equal(_n(tidx._sorted_shadow), _n(jidx._sorted_shadow))
        np.testing.assert_allclose(_n(tidx._sorted_shadow_sq), _n(jidx._sorted_shadow_sq),
                                   rtol=1e-6)
        if tidx._sorted_shadow_scales is not None:
            np.testing.assert_array_equal(_n(tidx._sorted_shadow_scales),
                                          _n(jidx._sorted_shadow_scales))
        np.testing.assert_array_equal(_n(tidx._shadow_pos), _n(jidx._shadow_pos))
    _, q = clustered()
    for nprobe in (2, 8):
        _agree(tidx.search(q, 10, nprobe=nprobe), jidx.search(q, 10, nprobe=nprobe))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unpinned_source_calls_equal_jax_and_rows_self_retrieve(name):
    """Unpinned, the port trains on the same prefix sample calls and the
    codebook sample, then the corpus passes: JAX's exact call list. Its own
    k-means then still retrieves each row (as the JAX test holds it)."""
    _, jcalls, _, _, free_calls, free = _built(name)
    assert free_calls == jcalls
    pts, _ = clustered()
    _, ids = free.search(pts[::97], 1, nprobe=8)
    assert (_n(ids)[:, 0] == np.arange(0, N, 97)).mean() >= 0.75


def _state(idx):
    return {k: np.array(v) for k, v in idx.state_dict().items()}


def test_jax_ivfpq_pending_reload_fault_is_not_copied():
    """The JAX package reloads an IVF-PQ index's pending tier wrong: the
    bf16 rows are saved as their uint16 bits and read back as values into a
    uint8 tier (its ``from_state_dict`` decodes the bits only where the LIST
    dtype is bf16), so JAX's own reload searches otherwise than the index it
    saved. The port reads the bits as bf16: its reload, of either package's
    file, equals the index that was saved."""
    jidx, _, tidx, _, _, _ = _built("pq")
    assert jidx._n_spill > 0
    jj = JIVF.from_state_dict(_state(jidx))
    assert str(jj._pending.dtype) != str(jidx._pending.dtype)
    assert not np.allclose(_n(jj._pending._sq), _n(jidx._pending._sq))
    for saved in (tidx, jidx):
        loaded = TIVF.from_state_dict(_state(saved), device="cpu")
        assert loaded._pending.dtype == torch.bfloat16
        np.testing.assert_array_equal(_n(loaded._pending._sq)[:loaded._pending.ntotal],
                                      _n(tidx._pending._sq)[:tidx._pending.ntotal])
        _agree(loaded.search(_Q, 10), tidx.search(_Q, 10))


def test_jax_reassign_choices_above_nlist_fault_is_not_copied():
    """JAX's ``balance="reassign"`` chunked build fills an (n, 16) array
    with ``assign_topk``'s (n, nlist) choices, so below 16 lists it raises;
    the port takes min(choices, nlist), as ``assign_topk`` does."""
    pts, _ = clustered(per=32)
    src = lambda s, z: pts[s:s + z]
    with pytest.raises(ValueError, match="broadcast"):
        JIVF(D, nlist=8, balance="reassign", train_iters=2).build_chunked(
            src, n=len(pts), chunk_size=256)
    idx = TIVF(D, nlist=8, nprobe=8, balance="reassign", train_iters=2, device="cpu")
    idx.build_chunked(src, n=len(pts), chunk_size=256)
    assert idx.ntotal == len(pts) and idx._window <= idx._reassign_cap(len(pts) / 8)
    _, ids = idx.search(pts[:8], 1)
    assert (_n(ids)[:, 0] == np.arange(8)).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_saved_index_loads_in_the_other_package_and_removes_agree(name):
    """The port reads JAX's file as JAX built it, and JAX reads the port's
    file as it reads its own (for IVF-PQ with a pending tier that is JAX's
    reload fault above, so there the port's own index is held to JAX's
    index instead). Rows removed in all of them, built and pending ones,
    leave searches and ``vectors()`` agreeing."""
    jidx, _, tidx, _, _, _ = _built(name)
    q = _Q
    port_in_jax = JIVF.from_state_dict(_state(tidx))
    jax_in_jax = JIVF.from_state_dict(_state(jidx))
    jax_in_port = TIVF.from_state_dict(_state(jidx), device="cpu")
    pairs = [(jax_in_port, jidx), (tidx, jidx), (port_in_jax, jax_in_jax)]
    if not tidx.pq_m:
        pairs.append((tidx, port_in_jax))
    for a, b in pairs:
        _agree(a.search(q, 10), b.search(q, 10))
    gone = np.r_[0, 7, 500, _n(tidx.search(q[:4], 3)[1]).ravel(), tidx._pending_rowids[:3]]
    for idx in (tidx, jidx, port_in_jax, jax_in_jax, jax_in_port):
        idx.remove_ids(gone)
    for a, b in pairs:
        assert a.nlive == b.nlive
        _agree(a.search(q, 10), b.search(q, 10))
        tv, ti = a.vectors(return_ids=True)
        jv, ji = b.vectors(return_ids=True)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
        assert not np.isin(ti, gone).any()
    _BUILT.pop(name)  # the cached indexes are changed
