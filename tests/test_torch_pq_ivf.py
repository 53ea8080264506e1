"""IVF-PQ in the port (index/ivf.py with ``pq_m``, ops/ivf_scan.py's PQ chunk
body) vs the JAX package.

Indexes built by JAX are cross-loaded through the "padded_v3" npz state
(centroids, codebooks, OPQ rotation, residual codes, norms, the refine
shadow) and searched in both packages; one built by the port goes the other
way. Tolerance: values within rtol x (max ||q||^2 + max ||x||^2) + rtol x
|value| (rtol 1e-5 at compute "f32", 1e-3 at "bf16": float32 sums of 64
products in different orders), ids equal except where values tie within
it. Rows are clustered (16 modes x 96, spread 0.25, D = 64), as in
tests/test_pq.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index.ivf import IVFFlatIndex as JIVF
from rag_faiss_embedding_tpu.index.pq import PQIndex as JPQ
from rag_faiss_embedding_tpu.ops import ivf_scan as jscan
from rag_faiss_embedding_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from rag_faiss_embedding_tpu_torch.index.pq import PQIndex as TPQ
from rag_faiss_embedding_tpu_torch.ops import ivf_scan as tscan
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD

from .test_torch_pq import assert_topk_close as _agree

D = 64
RTOL = {"f32": 1e-5, "bf16": 1e-3}


def clustered(seed=0, n_clusters=16, per=96, spread=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, D)).astype(np.float32) * 3
    pts = (centers[:, None] + spread * rng.standard_normal((n_clusters, per, D))
           ).reshape(-1, D).astype(np.float32)
    q = (pts[rng.choice(len(pts), 24, replace=False)]
         + 0.05 * rng.standard_normal((24, D))).astype(np.float32)
    return pts, q


def _state(idx):
    return {k: np.array(v) for k, v in idx.state_dict().items()}


_BUILT = {}
_JAX_HITS = {}
CONFIGS = {
    # name: (kwargs, pinned to the plain build's centroids + codebooks)
    "plain": (dict(pq_compute="f32"), False),
    "bf16": (dict(pq_compute="bf16"), True),
    "opq_int8": (dict(pq_compute="f32", pq_opq=True, rerank=True, rerank_depth=32), False),
    "refine_bf16": (dict(pq_compute="f32", rerank=True, refine_dtype="bfloat16"), True),
    "refine_f32": (dict(pq_compute="f32", rerank=True, rerank_depth=48,
                        refine_dtype="float32"), True),
}


def _jax_built(name):
    """A JAX-built IVF-PQ index (module cache: JAX's jit is the slow part)."""
    if name not in _BUILT:
        pts, q = clustered()
        kw, pinned = CONFIGS[name]
        idx = JIVF(D, nlist=8, nprobe=8, pq_m=16, train_iters=5, **kw)
        if pinned:
            base = _jax_built("plain")[0]
            idx.centroids, idx.is_trained = base.centroids, True
            idx.pq_codebooks = base.pq_codebooks
        idx.build(pts)
        _BUILT[name] = (idx, pts, q)
    return _BUILT[name]


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_ivfpq_loads_in_port_and_searches_agree(name, backend):
    jidx, pts, q = _jax_built(name)
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu", backend=backend)
    assert tidx.pq_m == 16 and tidx.dtype == torch.uint8 and tidx._window == jidx._window
    assert tidx.rerank == jidx.rerank and tidx.refine_dtype == jidx.refine_dtype
    assert tidx.rerank_depth == jidx.rerank_depth and (tidx.pq_rot is not None) == jidx.pq_opq
    np.testing.assert_allclose(tidx.vectors(), jidx.vectors(), rtol=1e-6, atol=1e-6)
    rtol = RTOL[tidx.pq_compute]
    for nprobe, k in ((2, 10), (8, 5), (8, 40)):
        key = (name, nprobe, k)  # JAX's answer is the same for both backends
        if key not in _JAX_HITS:
            _JAX_HITS[key] = jidx.search(q, k, nprobe=nprobe)
        _agree(tidx.search(q, k, nprobe=nprobe), _JAX_HITS[key], q, pts, rtol)
    assert tidx.resolved_dispatch(len(q)) == jidx.resolved_dispatch(len(q))


def test_port_ivfpq_with_opq_and_refine_loads_in_jax():
    pts, q = clustered(seed=1)
    tidx = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", pq_opq=True,
                rerank=True, rerank_depth=48, train_iters=5, device="cpu")
    tidx.build(pts)
    r = tidx.pq_rot.double()
    assert torch.allclose(r @ r.T, torch.eye(D, dtype=torch.float64), atol=1e-5)
    jidx = JIVF.from_state_dict(_state(tidx))
    assert jidx.pq_opq and jidx.rerank and jidx.rerank_depth == 48
    np.testing.assert_array_equal(np.asarray(jidx._sorted_shadow),
                                  tidx._sorted_shadow[tidx._shadow_pos[
                                      tidx._sorted_ids >= 0].long()].numpy())
    _agree(tidx.search(q, 10), jidx.search(q, 10), q, pts, RTOL["f32"])
    again = TIVF.from_state_dict(_state(tidx), device="cpu")
    assert torch.equal(again.search(q, 10)[1], tidx.search(q, 10)[1])
    # exact self-queries: recall@1 through the codec, as tests/test_pq.py asks
    _, pred = tidx.search(pts[::64], 1)
    assert (pred[:, 0].numpy() == np.arange(0, len(pts), 64)).mean() >= 0.9


def test_union_segmentation_matches_unsegmented(monkeypatch):
    """useg > 1 (a tiny step budget) gives the single-pass result, in both
    packages, also with the refine shadow and a filter on top."""
    for name in ("plain", "opq_int8"):
        jidx, pts, q = _jax_built(name)
        tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
        v1, i1 = tidx.search(q, 10)
        assert tscan._pq_union_segments(8, tidx._window, 16, D, 24) == 1
        monkeypatch.setattr(tscan, "_STEP_BYTES_BUDGET", 1 << 20)
        monkeypatch.setattr(jscan, "_STEP_BYTES_BUDGET", 1 << 20)
        assert tscan._pq_union_segments(8, tidx._window, 16, D, 24) > 1
        v2, i2 = tidx.search(q, 10)
        assert torch.equal(i1, i2)
        torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
        _agree((v2, i2), jidx.search(q, 10), q, pts, RTOL["f32"])
        mask = np.zeros(len(pts), bool)
        mask[::2] = True
        i3 = _agree(tidx.search(q, 5, filter_mask=mask), jidx.search(q, 5, filter_mask=mask),
                    q, pts, RTOL["f32"])
        assert mask[i3[i3 >= 0]].all()
        monkeypatch.undo()


@pytest.mark.parametrize("u_n,window,m,d,qc", [(8, 640, 16, 64, 24), (2048, 256, 48, 384, 256),
                                               (130, 256, 48, 384, 8), (1616, 256, 48, 384, 256)])
def test_pq_union_segments_match_jax(u_n, window, m, d, qc):
    assert tscan._pq_union_segments(u_n, window, m, d, qc) == \
        jscan._pq_union_segments(u_n, window, m, d, qc)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("nq,nlist,nprobe", [(1, 8192, 8), (1024, 8192, 128), (20, 64, 8)])
def test_pq_dispatch_matches_jax(backend, platform, nq, nlist, nprobe):
    """PQ storage: qc = min(256, union_cap) (>= 16), backend "auto" -> the
    plain chunk body, on the card as on a TPU."""
    common = dict(nq=nq, dim=384, nlist=nlist, window=256, code_bytes=1, quantized=False,
                  has_shadow=False, has_pq=True, has_filter=False, nprobe=nprobe,
                  backend=backend)
    jplat = {"cuda": "tpu"}.get(platform, platform)
    try:
        want = jscan.resolve_fused_dispatch(platform=jplat, **common)
    except ValueError:
        with pytest.raises(ValueError):
            tscan.resolve_fused_dispatch(platform=platform, **common)
        return
    assert tscan.resolve_fused_dispatch(platform=platform, **common) == want


def test_refine_shadow_is_compact():
    """The D-wide refine shadow stays (n_rows, D) with an int32 slot -> row
    map through build and reload; dead slots map to -1."""
    pts, _ = clustered()
    idx = TIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", rerank=True,
               rerank_depth=32, refine_dtype="bfloat16", train_iters=5, device="cpu")
    idx.build(pts)
    n_slots = (idx.nlist + 1) * idx._window
    assert idx._sorted_shadow.shape == (len(pts), D)
    assert idx._shadow_pos.shape == (n_slots,) and idx._shadow_pos.dtype == torch.int32
    ids, pos = idx._sorted_ids.numpy(), idx._shadow_pos.numpy()
    live = np.flatnonzero(ids >= 0)
    np.testing.assert_allclose(idx._sorted_shadow[pos[live]].float().numpy(), pts[ids[live]],
                               rtol=0.01, atol=0.01)
    assert (pos[ids < 0] == -1).all()
    loaded = TIVF.from_state_dict(_state(idx), device="cpu")
    assert loaded._sorted_shadow.shape == (loaded._n_built, D)
    assert torch.equal(loaded.search(pts[:8], 5)[1], idx.search(pts[:8], 5)[1])


def test_refine_edge_cases_match_jax():
    """k > rerank_depth, remove_ids and filter_mask through the refine."""
    jidx, pts, q = _jax_built("opq_int8")
    jidx = JIVF.from_state_dict(_state(jidx))  # a private copy
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    v, i = tidx.search(q[:4], 40)
    assert (i >= 0).all() and torch.isfinite(v).all()
    _agree((v, i), jidx.search(q[:4], 40), q[:4], pts, RTOL["f32"])
    d = ((q.astype(np.float64)[:, None] - pts.astype(np.float64)[None]) ** 2).sum(-1)
    nearest = np.unique(np.argsort(d, axis=1, kind="stable")[:, 0])
    assert tidx.remove_ids(nearest) == jidx.remove_ids(nearest) == len(nearest)
    ti = _agree(tidx.search(q, 5), jidx.search(q, 5), q, pts, RTOL["f32"])
    assert not np.isin(ti, nearest).any()
    mask = np.zeros(tidx.ntotal, bool)
    mask[::3] = True
    mask[nearest] = False
    ti = _agree(tidx.search(q, 5, filter_mask=mask), jidx.search(q, 5, filter_mask=mask),
                q, pts, RTOL["f32"])
    assert mask[ti[ti >= 0]].all()
    # a filter that leaves fewer live rows than the candidate pool: the
    # re-score must not bring a masked row back
    few = np.zeros(tidx.ntotal, bool)
    few[nearest[:3] + 1] = True
    ti = _agree(tidx.search(q, 10, nprobe=8, filter_mask=few),
                jidx.search(q, 10, nprobe=8, filter_mask=few), q, pts, RTOL["f32"])
    assert few[ti[ti >= 0]].all() and (ti[:, 3:] == -1).all()


def test_streaming_add_remove_filter_and_rebuild_match_jax():
    jidx, pts, q = _jax_built("plain")
    jidx = JIVF.from_state_dict(_state(jidx))
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    extra = pts[:8] + 0.001
    jidx.add(extra)
    tidx.add(extra)
    assert tidx._pending.dtype == torch.bfloat16 and tidx._pending.ntotal == 8
    got = _agree(tidx.search(extra, 1), jidx.search(extra, 1), extra, pts, RTOL["f32"])[:, 0]
    assert ((got == np.arange(len(pts), len(pts) + 8)) | (got == np.arange(8))).all()
    tidx.remove_ids(np.arange(4))
    jidx.remove_ids(np.arange(4))
    ti = _agree(tidx.search(pts[:4], 3), jidx.search(pts[:4], 3), pts[:4], pts, RTOL["f32"])
    assert not np.isin(ti, np.arange(4)).any()
    # the pending tier reloads as bf16 rows (JAX reloads it as uint8: ROADMAP Queue 3)
    again = TIVF.from_state_dict(_state(tidx), device="cpu")
    assert again._pending.dtype == torch.bfloat16
    np.testing.assert_array_equal(again._pending.vectors(), tidx._pending.vectors())
    assert torch.equal(again.search(extra, 1)[1], tidx.search(extra, 1)[1])
    tidx.rebuild()
    jidx.rebuild()
    assert tidx._pending.ntotal == jidx._pending.ntotal == 0
    assert tidx.ntotal == jidx.ntotal and tidx.nlive == jidx.nlive
    _agree(tidx.search(q, 10), jidx.search(q, 10), q, pts, RTOL["f32"])


def test_jax_saved_float32_refine_shadow_loads_exactly():
    """A float32 refine shadow saves as float32 values; the port loads it
    as float32 (JAX reloads it as bf16 bits of twice the width: ROADMAP
    Queue 3)."""
    jidx, pts, q = _jax_built("refine_f32")
    state = _state(jidx)
    assert state["shadow"].dtype == np.float32
    tidx = TIVF.from_state_dict(state, device="cpu")
    assert tidx._sorted_shadow.dtype == torch.float32
    assert tidx._sorted_shadow.shape == (tidx._n_built, D)
    np.testing.assert_array_equal(tidx.vectors(), jidx.vectors())
    _agree(tidx.search(q, 10), jidx.search(q, 10), q, pts, RTOL["f32"])


def test_ip_metric_matches_jax():
    pts, q = clustered(seed=2)
    jidx = JIVF(D, nlist=8, nprobe=8, pq_m=16, pq_compute="f32", metric="IP", train_iters=5)
    jidx.base = _jax_built("plain")[0]
    jidx.centroids, jidx.is_trained = jidx.base.centroids, True
    jidx.build(pts)
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
    ti = _agree(tidx.search(q, 10), jidx.search(q, 10), q, pts, RTOL["f32"])
    truth = np.argsort(-(q @ pts.T), 1)[:, :10]
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, truth)]) > 0.35


def test_validations_match_jax():
    for kw in (dict(pq_m=16, dtype="int8"), dict(pq_m=16, refine_dtype="fp4"),
               dict(pq_m=16, pq_compute="f16")):
        with pytest.raises(ValueError):
            JIVF(D, **kw)
        with pytest.raises(ValueError):
            TIVF(D, device="cpu", **kw)
    with pytest.raises(ValueError):
        TIVF(65, pq_m=16, device="cpu")
    idx = TIVF(D, pq_m=16, rerank=True, device="cpu")
    assert idx.rerank and idx.rerank_depth == 64 and idx.refine_dtype == "int8"
    assert TIVF(D, pq_m=16, device="cpu").rerank_depth == 16


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_f32_compute_decodes_in_float32(kind):
    """compute "f32" decodes float32 codewords, as the JAX package does off
    the TPU (its CPU path is the reference here). On a TPU the JAX package
    decodes through the bf16 grouped codebook even at "f32" (its
    backend="pallas" in interpret mode shows it); the port does not copy
    that (ROADMAP Queue 3)."""
    pts, q = clustered(seed=3, n_clusters=8, per=128)
    pts, q = np.tile(pts, (1, 2)), np.tile(q, (1, 2))  # D = 128: the TPU kernel's shape
    if kind == "flat":
        jidx = JPQ(128, m=16, compute_dtype="f32", train_iters=4)
        jidx.build(pts)
        tidx = TPQ.from_state_dict(_state(jidx), device="cpu")
        tpu = JPQ.from_state_dict(_state(jidx), backend="pallas")
    else:
        jidx = JIVF(128, nlist=4, nprobe=4, pq_m=16, pq_compute="f32", train_iters=4)
        jidx.build(pts)
        tidx = TIVF.from_state_dict(_state(jidx), device="cpu")
        tpu = JIVF.from_state_dict(_state(jidx), backend="pallas")
    tv, ti = tidx.search(q, 5)
    _agree((tv, ti), jidx.search(q, 5), q, pts, RTOL["f32"])
    # the bf16 decode's error is far outside the f32 tolerance
    atol = RTOL["f32"] * float((q.astype(np.float64) ** 2).sum(1).max()
                               + (pts.astype(np.float64) ** 2).sum(1).max())
    bf16_v, _ = tpu.search(q, 5)
    assert np.abs(np.asarray(bf16_v) - tv.numpy()).max() > 10 * atol


def test_cpu_ivfpq_never_counts_a_launch():
    jidx, pts, q = _jax_built("plain")
    tidx = TIVF.from_state_dict(_state(jidx), device="cpu", backend="pallas")
    before = PD.decode.launches
    tidx.search(q, 10)
    tidx.vectors()
    assert PD.decode.launches == before
    assert tidx.resolved_dispatch(len(q))["backend"] == "xla"


def test_kernel_wrapper_and_plain_decode_routes_agree_on_cpu():
    jidx, pts, q = _jax_built("bf16")
    a = TIVF.from_state_dict(_state(jidx), device="cpu", backend="auto")
    b = TIVF.from_state_dict(_state(jidx), device="cpu", backend="xla")
    va, ia = a.search(q, 10)
    vb, ib = b.search(q, 10)
    assert torch.equal(ia, ib) and torch.equal(va, vb)
    assert jnp.asarray(jidx._sorted_vecs).dtype == jnp.uint8
