"""IVF-Flat port (index/ivf.py, ops/ivf_scan.py) vs the JAX package.

Indexes are cross-loaded through the npz state ("padded_v3"): one built by
JAX loads in the port and the reverse, and searches on the same state agree
in both packages. The plain chunk body is held to JAX ``backend="xla"`` and
the kernel route's plain version (``union_scan_reference`` on a CPU index)
to JAX ``backend="pallas"`` in interpret mode. Tolerance: ids identical,
distances to rtol 1e-5 / atol 1e-3 (float32 sums of 128 products in
different orders; the data holds no near-ties at that scale). k-means
itself is not compared here: the RNGs differ (tests/test_torch_kmeans.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index.ivf import IVFFlatIndex as JIVF
from rag_faiss_embedding_tpu.ops import ivf_scan as jscan
from rag_faiss_embedding_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from rag_faiss_embedding_tpu_torch.index.ivf import probe_scan_math
from rag_faiss_embedding_tpu_torch.ops import ivf_scan as tscan
from rag_faiss_embedding_tpu_torch.ops import union_scan as U

RTOL, ATOL = 1e-5, 1e-3
D = 128


def _data(seed=0, n_modes=16, per=64, metric="L2"):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, D)).astype(np.float32)
    pts = (centers[rng.integers(0, n_modes, n_modes * per)]
           + 0.4 * rng.standard_normal((n_modes * per, D))).astype(np.float32)
    q = (pts[::29] + 0.2 * rng.standard_normal((len(pts[::29]), D))).astype(np.float32)
    if metric == "IP":
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return pts, q


def _state(idx):
    return {k: np.array(v) for k, v in idx.state_dict().items()}


def _agree(t_out, j_out):
    tv, ti = (x.cpu().numpy() for x in t_out)
    jv, ji = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=ATOL)
    return ti


def _set(idx, backend, variant):
    idx.backend, idx.pallas_variant = backend, variant


_JAX_BUILT = {}


def _jax_built(metric, dtype, balance):
    """A JAX-built index (module cache: k-means under jit is the slow part)."""
    key = (metric, dtype, balance)
    if key not in _JAX_BUILT:
        pts, q = _data(metric=metric)
        idx = JIVF(D, nlist=16, metric=metric, dtype=dtype, train_iters=5, balance=balance)
        idx.build(pts)
        _JAX_BUILT[key] = (idx, pts, q)
    return _JAX_BUILT[key]


ROUTES = [("xla", 1), ("pallas", 1), ("pallas", 2)]


@pytest.mark.parametrize("backend,variant", ROUTES)
@pytest.mark.parametrize("metric,dtype,balance", [
    ("L2", "float32", "spill"), ("L2", "bfloat16", "reassign"),
    ("IP", "float32", "reassign"),
])
def test_jax_index_loads_in_port_and_searches_agree(metric, dtype, balance, backend, variant):
    jidx, pts, q = _jax_built(metric, dtype, balance)
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    assert tidx._window == jidx._window and tidx.ntotal == jidx.ntotal
    np.testing.assert_array_equal(tidx.vectors(), jidx.vectors())
    _set(jidx, backend, variant)
    _set(tidx, backend, variant)
    ti = _agree(tidx.search(q, 10, nprobe=4), jidx.search(q, 10, nprobe=4))
    assert (ti >= 0).all()
    assert tidx.resolved_dispatch(len(q)) == jidx.resolved_dispatch(len(q))


def test_port_index_loads_in_jax(tmp_path):
    pts, q = _data(seed=1)
    tidx = TIVF(D, nlist=16, train_iters=5, balance="reassign", device="cpu")
    tidx.build(pts)
    assert tidx._n_spill == 0 and tidx._n_built == len(pts)
    path = tmp_path / "ivf.npz"
    np.savez_compressed(path, **tidx.state_dict())
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    jidx = JIVF.from_state_dict(state)
    np.testing.assert_array_equal(jidx.vectors(), tidx.vectors())
    for backend, variant in ROUTES:
        _set(jidx, backend, variant)
        _set(tidx, backend, variant)
        _agree(tidx.search(q, 10, nprobe=4), jidx.search(q, 10, nprobe=4))
    # and back again: the reloaded port index answers the same
    again = TIVF.from_state_dict(state, device="cpu")
    assert torch.equal(again.search(q, 10)[1], tidx.search(q, 10)[1])


def _synthetic_state(nlist, n, seed=0, dtype="float32"):
    """A "padded_v3" state for a large-nlist index without k-means: random
    centroids, rows assigned to their nearest one (numpy)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((nlist, D)).astype(np.float32)
    pts = (cents[rng.integers(0, nlist, n)]
           + 0.3 * rng.standard_normal((n, D))).astype(np.float32)
    assign = np.argmax(2 * pts @ cents.T - (cents * cents).sum(1), axis=1)
    order = np.argsort(assign, kind="stable")
    lengths = np.bincount(assign, minlength=nlist)
    window = int(-(-lengths.max() // 128) * 128)
    codes = pts[order]
    state = dict(kind="ivf", format="padded_v3", dim=D, metric="L2", dtype=dtype,
                 nlist=nlist, nprobe=8, window_quantile=0.98, balance="spill",
                 window=window, next_id=n, rerank_depth=16, n_streamed=0,
                 n_spill=0, centroids=cents, assign_bias=np.zeros(0, np.float32),
                 codes=codes, sqnorms=(codes * codes).sum(1).astype(np.float32),
                 sorted_ids=order.astype(np.int32), lengths=lengths.astype(np.int64))
    q = (pts[::97] + 0.1 * rng.standard_normal((len(pts[::97]), D))).astype(np.float32)
    return state, q[:24]


@pytest.mark.parametrize("backend,variant", ROUTES)
def test_chunkmax_union_matches_jax(backend, variant):
    """nlist > 2048 takes the chunk-aggregate union (``chunkmax``); JAX's
    approximate coarse selection is exact off the TPU, as the port's is."""
    state, q = _synthetic_state(2304, 6000)
    jidx, tidx = JIVF.from_state_dict(state), TIVF.from_state_dict(state, device="cpu")
    assert tidx._resolved_union_mode() == "chunkmax"
    _set(jidx, backend, variant)
    _set(tidx, backend, variant)
    _agree(tidx.search(q, 10), jidx.search(q, 10))


@pytest.mark.parametrize("backend,variant", ROUTES)
def test_remove_ids_matches_jax(backend, variant):
    jidx, pts, q = _jax_built("L2", "float32", "spill")
    jidx = JIVF.from_state_dict(_state(jidx))  # a private copy
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    _set(jidx, backend, variant)
    _set(tidx, backend, variant)
    kill = np.unique(tidx.search(q[:8], 3, nprobe=8)[1].numpy()[:, 0])
    assert tidx.remove_ids(kill) == jidx.remove_ids(kill) == len(kill)
    assert tidx.nlive == jidx.nlive
    ti = _agree(tidx.search(q, 10, nprobe=4), jidx.search(q, 10, nprobe=4))
    assert not np.isin(ti, kill).any()
    # save / load drops the tombstones (compaction) in both packages
    _agree(TIVF.from_state_dict(_state(tidx), device="cpu").search(q, 10, nprobe=4),
           JIVF.from_state_dict(_state(jidx)).search(q, 10, nprobe=4))


def test_filter_mask_matches_jax():
    jidx, pts, q = _jax_built("L2", "bfloat16", "reassign")
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    mask = np.random.default_rng(3).random(len(pts)) < 0.5
    for backend in ("auto", "pallas"):  # a filter routes both to the chunk body
        _set(jidx, backend, 1)
        _set(tidx, backend, 1)
        ti = _agree(tidx.search(q, 10, nprobe=4, filter_mask=mask),
                    jidx.search(q, 10, nprobe=4, filter_mask=mask))
        assert mask[ti[ti >= 0]].all()
    with pytest.raises(ValueError, match="filter_mask"):
        tidx.search(q, 5, filter_mask=mask[:-1])


@pytest.mark.parametrize("backend,variant", ROUTES)
def test_streaming_add_and_rebuild_match_jax(backend, variant):
    jidx, pts, q = _jax_built("L2", "float32", "spill")
    jidx = JIVF.from_state_dict(_state(jidx))
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    _set(jidx, backend, variant)
    _set(tidx, backend, variant)
    extra = np.random.default_rng(9).standard_normal((40, D)).astype(np.float32)
    jidx.add(extra)
    tidx.add(extra)
    assert tidx._pending.ntotal == jidx._pending.ntotal == 40
    ti = _agree(tidx.search(extra[:6], 5), jidx.search(extra[:6], 5))
    np.testing.assert_array_equal(ti[:, 0], len(pts) + np.arange(6))
    tidx.remove_ids([len(pts) + 1])
    jidx.remove_ids([len(pts) + 1])
    _agree(tidx.search(extra[:6], 5), jidx.search(extra[:6], 5))
    # a cross-loaded pending tier, then rebuild with the same centroids
    _agree(TIVF.from_state_dict(_state(jidx), device="cpu").search(q, 10),
           jidx.search(q, 10))
    tidx.rebuild()
    jidx.rebuild()
    assert tidx._pending.ntotal == jidx._pending.ntotal
    assert tidx.ntotal == jidx.ntotal and tidx.nlive == jidx.nlive
    _agree(tidx.search(q, 10), jidx.search(q, 10))


@pytest.mark.parametrize("backend,variant", ROUTES)
def test_k_beyond_candidates_pads(backend, variant):
    jidx, pts, q = _jax_built("L2", "float32", "spill")
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    _set(jidx, backend, variant)
    _set(tidx, backend, variant)
    tv, ti = tidx.search(q[:4], 300, nprobe=1)
    assert ti.shape == (4, 300)
    assert (ti[:, 0] >= 0).all() and (ti[:, -1] == -1).all()
    assert torch.isinf(tv[ti == -1]).all()
    _agree((tv, ti), jidx.search(q[:4], 300, nprobe=1))


def test_empty_and_pending_only_indexes():
    idx = TIVF(D, nlist=4, device="cpu")
    v, i = idx.search(np.zeros((2, D), np.float32), 3)
    assert (i == -1).all() and torch.isinf(v).all()
    pts, q = _data()
    idx.build(pts[:200])
    idx.remove_ids(np.arange(200))
    idx.rebuild()  # every row tombstoned: an empty rebuild
    assert idx.nlive == 0


GRID = [
    dict(nq=1, dim=384, nlist=8192, window=256, code_bytes=2, nprobe=8),
    dict(nq=1024, dim=384, nlist=8192, window=256, code_bytes=2, nprobe=16),
    dict(nq=20, dim=128, nlist=16, window=128, code_bytes=4, nprobe=4),
    dict(nq=3, dim=100, nlist=64, window=128, code_bytes=4, nprobe=8),
    dict(nq=64, dim=128, nlist=64, window=192, code_bytes=2, nprobe=8),
    dict(nq=500, dim=768, nlist=1024, window=1408, code_bytes=4, nprobe=64),
]


@pytest.mark.parametrize("kw", GRID)
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("has_filter", [False, True])
def test_resolve_fused_dispatch_matches_jax(kw, backend, platform, has_filter):
    """The port on a CUDA index resolves what JAX resolves on a TPU; on a
    CPU index what JAX resolves off the TPU."""
    common = dict(kw, quantized=False, has_shadow=False, has_pq=False,
                  has_filter=has_filter, backend=backend)
    jplat = {"cuda": "tpu"}.get(platform, platform)
    try:
        want = jscan.resolve_fused_dispatch(platform=jplat, **common)
    except ValueError:
        with pytest.raises(ValueError):
            tscan.resolve_fused_dispatch(platform=platform, **common)
        return
    assert tscan.resolve_fused_dispatch(platform=platform, **common) == want


@pytest.mark.parametrize("nlist,nprobe", [(16, 8), (8192, 8), (64, 1)])
def test_union_cap_and_query_chunk_match_jax(nlist, nprobe):
    assert tscan.default_union_cap(nlist, nprobe) == jscan.default_union_cap(nlist, nprobe)
    for nq in (1, 100, 5000):
        assert (tscan.pick_query_chunk(nprobe, 256, 384, 2, nq, nlist=nlist)
                == jscan.pick_query_chunk(nprobe, 256, 384, 2, nq, nlist=nlist))


def test_select_union_matches_jax():
    import jax

    rng = np.random.default_rng(4)
    probes = np.stack([np.stack([rng.permutation(40)[:6] for _ in range(16)])
                       for _ in range(3)]).astype(np.int32)
    for cap in (8, 24, 64):
        want = jax.vmap(lambda p: jscan._select_union(p, 40, cap))(probes)
        got = tscan._select_union(torch.from_numpy(probes), 40, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend,variant", ROUTES)
def test_recall_against_numpy_exact(backend, variant):
    pts, q = _data(seed=5)
    idx = TIVF(D, nlist=16, train_iters=5, balance="reassign", device="cpu")
    idx.build(pts)
    _set(idx, backend, variant)
    _, ids = idx.search(q, 10, nprobe=16)  # full probe
    d = ((q[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids.numpy(), truth)])
    assert recall >= 0.995


def test_probe_scan_oracle_agrees_with_fused_full_probe():
    """The per-query windowed scan (kept as the oracle) and the fused search
    at full probe give the same neighbours."""
    pts, q = _data(seed=6)
    idx = TIVF(D, nlist=16, train_iters=5, balance="reassign", device="cpu")
    idx.build(pts)
    assert idx._pending.ntotal == 0
    probes = torch.arange(16)[None].expand(len(q), -1)
    ov, oi = probe_scan_math(torch.from_numpy(q), idx._sorted_vecs, idx._sorted_sq,
                             idx._sorted_ids, idx._offsets.long(), idx._lengths.long(),
                             probes, k=10, window=idx._window)
    fv, fi = idx.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(oi.numpy(), fi.numpy())
    np.testing.assert_allclose(ov.numpy(), fv.numpy(), rtol=RTOL, atol=ATOL)


def test_not_ported_yet_raise_naming_the_slice():
    """int8 storage and ``rerank`` are ported (the int8 tier): int8 reranks
    by default, float storage keeps no shadow (as in JAX), and int8 or a
    shadow refuse the kernel route with JAX's ``ValueError``. ``build_chunked``
    no longer raises: it equals the dense build."""
    for rerank, shadow in ((None, True), (True, True), (False, False)):
        idx = TIVF(D, nlist=4, dtype="int8", rerank=rerank, train_iters=2, device="cpu")
        assert idx.quantized and idx.rerank == shadow and idx._pending.quantized
        idx.build(_data()[0][:512])
        assert (idx._sorted_shadow is not None) == shadow
        assert idx._cent_store.dtype == torch.bfloat16 and idx._sorted_scales is not None
    assert TIVF(D, rerank=True, device="cpu").rerank
    # IVF-PQ: pq_m gives uint8 code storage, and with it rerank keeps a
    # refine shadow
    pq = TIVF(D, pq_m=16, rerank=True, device="cpu")
    assert pq.dtype == torch.uint8 and pq.rerank and pq.refine_dtype == "int8"
    # build_chunked is ported: with training pinned, a tiny chunked build
    # equals the dense build
    rows = _data()[0][:512]
    dense = TIVF(D, nlist=4, train_iters=2, device="cpu")
    dense.build(rows)
    chunked = TIVF(D, nlist=4, device="cpu")
    chunked.centroids, chunked.is_trained = dense.centroids, True
    chunked.build_chunked(lambda s, z: rows[s:s + z], n=len(rows), chunk_size=200)
    assert chunked._window == dense._window
    for name in ("_sorted_ids", "_sorted_vecs", "_sorted_sq", "_lengths"):
        assert torch.equal(getattr(chunked, name), getattr(dense, name)), name
    args = (torch.zeros(1, D), torch.zeros(2, D), torch.zeros(2),
            torch.zeros(3 * 128, D, dtype=torch.int8), torch.ones(3 * 128),
            torch.zeros(3 * 128), torch.zeros(3 * 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="pallas"):
        tscan.fused_ivf_search(*args, k=1, nprobe=1, window=128, backend="pallas")
    jargs = [jnp.asarray(a.numpy()) for a in args]
    _agree(tscan.fused_ivf_search(*args, k=1, nprobe=1, window=128),
           jscan.fused_ivf_search(*jargs, k=1, nprobe=1, window=128))


_JAX_INT8 = {}


def _jax_int8(metric, balance, rerank):
    """A JAX-built int8 index with a streamed pending tier (module cache)."""
    key = (metric, balance, rerank)
    if key not in _JAX_INT8:
        pts, q = _data(metric=metric)
        idx = JIVF(D, nlist=16, metric=metric, dtype="int8", train_iters=5,
                   balance=balance, rerank=rerank)
        idx.build(pts)
        idx.add(pts[:40] + 0.01)
        _JAX_INT8[key] = (idx, pts, q)
    return _JAX_INT8[key]


INT8_CASES = [("L2", "spill", None), ("IP", "reassign", None), ("L2", "reassign", False)]


@pytest.mark.parametrize("metric,balance,rerank", INT8_CASES)
def test_int8_jax_index_loads_in_port_and_searches_agree(metric, balance, rerank):
    """A JAX-built dense int8 index (with its bf16 shadow by default, and
    without) loads in the port: the codes, scales, shadow and pending tier
    arrive bit for bit, and searches agree (ids equal; values to rtol 1e-5 /
    atol 1e-3: the int32 dots are exact, the shadow's re-score is summed in
    another order) at several nprobe and k, after removals and with a
    filter; the dequantized rows equal JAX's."""
    jidx, pts, q = _jax_int8(metric, balance, rerank)
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    assert tidx.quantized and tidx.rerank == (rerank is not False)
    np.testing.assert_array_equal(tidx._sorted_vecs.numpy(), np.asarray(jidx._sorted_vecs))
    np.testing.assert_array_equal(tidx._sorted_scales.numpy(),
                                  np.asarray(jidx._sorted_scales))
    if tidx.rerank:
        np.testing.assert_array_equal(tidx._sorted_shadow.float().numpy(),
                                      np.asarray(jidx._sorted_shadow, np.float32))
    assert tidx._pending.ntotal == jidx._pending.ntotal == 40
    for k in (1, 10):
        for nprobe in (2, 16):
            _agree(tidx.search(q, k, nprobe=nprobe), jidx.search(q, k, nprobe=nprobe))
    np.testing.assert_array_equal(tidx.vectors(), np.asarray(jidx.vectors()))
    gone = np.arange(0, 1064, 7)
    tidx.remove_ids(gone)
    jidx = JIVF.from_state_dict(_state(jidx))
    jidx.remove_ids(gone)
    ids = _agree(tidx.search(q, 10), jidx.search(q, 10))
    assert not np.isin(ids, gone).any()
    filt = np.ones(jidx.ntotal, bool)
    filt[::3] = False
    ids = _agree(tidx.search(q, 10, filter_mask=filt), jidx.search(q, 10, filter_mask=filt))
    assert filt[ids[ids >= 0]].all()


@pytest.mark.parametrize("metric,balance,rerank", INT8_CASES)
def test_int8_port_index_loads_in_jax(tmp_path, metric, balance, rerank):
    """A port-built int8 index, streamed adds and tombstones included, saved
    and reloaded by JAX (and back): JAX's keys and dtypes; both packages
    search it the same; the JAX reload keeps (or lacks) the shadow."""
    pts, q = _data(seed=3, metric=metric)
    tidx = TIVF(D, nlist=16, metric=metric, dtype="int8", train_iters=5,
                balance=balance, rerank=rerank, device="cpu")
    tidx.build(pts)
    tidx.add(pts[:30] + 0.02)
    tidx.remove_ids([1, 2, 1030])
    state = _state(tidx)
    assert state["codes"].dtype == np.int8 and state["scales"].dtype == np.float32
    assert state["pending_scales"].dtype == np.float32
    assert ("shadow" in state) == (rerank is not False)
    np.savez(tmp_path / "t.npz", **state)
    jidx = JIVF.from_state_dict(dict(np.load(tmp_path / "t.npz")))
    assert jidx.quantized and jidx.rerank == (rerank is not False)
    _agree(tidx.search(q, 10), jidx.search(q, 10))
    back = TIVF.from_state_dict(_state(jidx), device="cpu")
    _agree(back.search(q, 10, nprobe=4), jidx.search(q, 10, nprobe=4))
    # rebuild merges the pending tier, re-quantizing the dequantized rows
    tidx.rebuild()
    jidx.rebuild()
    _agree(tidx.search(q, 10), jidx.search(q, 10))


@pytest.mark.parametrize("kw", GRID)
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("quantized,has_shadow", [(True, True), (True, False),
                                                  (False, True)])
def test_resolve_fused_dispatch_int8_matches_jax(kw, backend, platform, quantized,
                                                 has_shadow):
    """int8 storage or a dense shadow: "auto" picks the plain chunk body and
    "pallas" raises, on a CUDA index as on a TPU."""
    common = dict(kw, quantized=quantized, has_shadow=has_shadow, has_pq=False,
                  has_filter=False, backend=backend)
    jplat = {"cuda": "tpu"}.get(platform, platform)
    if backend == "pallas":
        for fn, plat in ((jscan.resolve_fused_dispatch, jplat),
                         (tscan.resolve_fused_dispatch, platform)):
            with pytest.raises(ValueError):
                fn(platform=plat, **common)
        return
    want = jscan.resolve_fused_dispatch(platform=jplat, **common)
    assert want["backend"] == "xla"
    assert tscan.resolve_fused_dispatch(platform=platform, **common) == want


def test_cpu_index_never_counts_a_launch():
    jidx, pts, q = _jax_built("L2", "float32", "spill")
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    before = U.union_scan.launches
    _set(tidx, "pallas", 2)
    tidx.search(q, 10)
    assert U.union_scan.launches == before
    assert tidx.resolved_dispatch(len(q))["interpret"]
