"""Product quantization in the port (ops/pq.py, index/pq.py) vs the JAX package.

The same rows (numpy, seeded) and the same codebooks go through both
packages on the CPU. Tolerances:
- encode: codes equal except at float32 near-ties, where the port's code
  must score within 1e-5 x (||x_sub||^2 + max ||c||^2) of JAX's choice;
  norms to rtol 1e-6 (sums of 64 squares in another order);
- ADC search: values within rtol x (max ||q||^2 + max ||x̂||^2) + rtol x
  |value|, rtol 1e-5 at compute "f32" and 1e-3 at "bf16"; ids equal except
  where the values tie within that tolerance;
- training draws from different RNGs, so codebooks are compared by their
  reconstruction error (within 5% of JAX's) and searches by cross-loading.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.index.pq import PQIndex as JPQ
from rag_faiss_embedding_tpu.ops import pq as jpq
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.index.pq import PQIndex as TPQ
from rag_faiss_embedding_tpu_torch.ops import pq as tpq
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD

RTOL = {"f32": 1e-5, "bf16": 1e-3}
D = 64


def clustered(seed=0, n_clusters=32, per=64, d=D, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    return (centers[:, None] + spread * rng.standard_normal((n_clusters, per, d))
            ).reshape(-1, d).astype(np.float32)


@pytest.fixture(scope="module")
def codec():
    pts = clustered()
    cb = np.array(jpq.train_pq(pts, m=16, n_iters=8, seed=0))
    codes, sq = (np.array(a) for a in jpq.pq_encode(cb, pts))
    return pts, cb, codes, sq


def assert_topk_close(t_out, j_out, q, rec, rtol):
    """Port result vs JAX result: values within the stated tolerance, ids
    equal except at ties within it, -1 / inf slots identical."""
    tv, ti = (x.cpu().numpy() for x in t_out)
    jv, ji = (np.asarray(x) for x in j_out)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_array_equal(ti < 0, ~fin)
    atol = rtol * float((q.astype(np.float64) ** 2).sum(1).max()
                        + (rec.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=rtol, atol=atol)
    diff = ti != ji
    assert np.allclose(tv[diff], jv[diff], rtol=rtol, atol=atol)
    return ti


# -------------------------------------------------------------------- ops
def test_encode_matches_jax_up_to_near_ties(codec):
    pts, cb, jcodes, jsq = codec
    tcodes, tsq = tpq.pq_encode(torch.from_numpy(cb), pts, chunk_size=700)
    tcodes, tsq = tcodes.numpy(), tsq.numpy()
    assert tcodes.dtype == np.uint8 and tcodes.shape == jcodes.shape
    rows, subs = np.nonzero(tcodes != jcodes)
    assert len(rows) <= 0.001 * tcodes.size
    xs = pts.reshape(len(pts), 16, -1).astype(np.float64)
    c_max = (cb.astype(np.float64) ** 2).sum(-1).max()
    for r, s in zip(rows, subs):
        dist = ((xs[r, s][None] - cb[s].astype(np.float64)) ** 2).sum(-1)
        tol = 1e-5 * ((xs[r, s] ** 2).sum() + c_max)
        assert dist[tcodes[r, s]] <= dist[jcodes[r, s]] + tol
    same = (tcodes == jcodes).all(1)
    np.testing.assert_allclose(tsq[same], jsq[same], rtol=1e-6)
    rec = tpq.pq_decode(torch.from_numpy(cb), torch.from_numpy(tcodes)).numpy()
    np.testing.assert_allclose(tsq, (rec.astype(np.float64) ** 2).sum(1), rtol=1e-5)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_search_matches_jax(codec, metric, compute):
    pts, cb, codes, sq = codec
    rng = np.random.default_rng(1)
    q = rng.standard_normal((9, D)).astype(np.float32) * 2
    dead = rng.random(len(pts)) < 0.1
    rec = np.asarray(jpq.pq_decode(cb, codes))
    kw = dict(metric=metric, n_valid=len(pts) - 37, chunk_size=512, compute_dtype=compute)
    want = jpq.pq_search(q, codes, cb, sq, 10, dead=dead, **kw)
    for pq_w in (True, False):  # the kernel wrapper and the plain decode
        got = tpq.pq_search(q, torch.from_numpy(codes), torch.from_numpy(cb),
                            torch.from_numpy(sq), 10, dead=torch.from_numpy(dead),
                            pq_w=pq_w, **kw)
        ids = assert_topk_close(got, want, q, rec, RTOL[compute])
        assert not dead[ids[ids >= 0]].any() and (ids < len(pts) - 37).all()


def test_search_accepts_interpret_and_runs_the_plain_decode(codec, monkeypatch):
    """The JAX ``interpret`` argument: the port has no interpret mode, so
    ``interpret=True`` runs the plain decode even where ``pq_w`` asks for
    the kernel's wrapper; the result is the JAX interpret-mode search's."""
    pts, cb, codes, sq = codec
    q = pts[:4] + 0.01
    kw = dict(metric="L2", n_valid=len(pts), chunk_size=512, compute_dtype="f32")
    want = jpq.pq_search(q, codes, cb, sq, 5, **kw)
    calls = []
    monkeypatch.setattr(tpq, "decode", lambda *a, **k: calls.append(1) or PD.decode(*a, **k))
    got = tpq.pq_search(q, torch.from_numpy(codes), torch.from_numpy(cb),
                        torch.from_numpy(sq), 5, pq_w=True, interpret=True, **kw)
    assert not calls
    assert_topk_close(got, want, q, np.asarray(jpq.pq_decode(cb, codes)), RTOL["f32"])


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_search_k_beyond_rows_pads(codec, metric):
    pts, cb, codes, sq = codec
    q = pts[:3] + 0.01
    args = (q, codes[:5], cb, sq[:5], 9)
    want = jpq.pq_search(*args, metric=metric, n_valid=5, compute_dtype="f32")
    got = tpq.pq_search(q, torch.from_numpy(codes[:5]), torch.from_numpy(cb),
                        torch.from_numpy(sq[:5]), 9, metric=metric, n_valid=5,
                        compute_dtype="f32")
    ids = assert_topk_close(got, want, q, np.asarray(jpq.pq_decode(cb, codes[:5])),
                            RTOL["f32"])
    assert ids.shape == (3, 9) and (ids[:, 5:] == -1).all() and (ids[:, :5] >= 0).all()
    # n_valid inside a padded buffer: rows past it never come back
    v, i = tpq.pq_search(q, torch.from_numpy(codes), torch.from_numpy(cb),
                         torch.from_numpy(sq), 6, metric=metric, n_valid=2)
    assert (i[:, 2:] == -1).all() and torch.isinf(v[:, 2:]).all()


def test_train_pq_reconstruction_within_five_percent_of_jax(codec):
    pts, cb, _, _ = codec
    tcb = tpq.train_pq(pts, 16, n_iters=8, seed=0)
    assert tcb.shape == (16, 256, 4) and tcb.dtype == torch.float32

    def mse(book):
        c, _ = tpq.pq_encode(torch.as_tensor(book), pts)
        return float(((tpq.pq_decode(torch.as_tensor(book), c).numpy() - pts) ** 2).sum(1).mean())

    assert abs(mse(tcb) - mse(cb)) <= 0.05 * mse(cb)
    # same seed, same codebooks (the update sums in a fixed order)
    assert torch.equal(tcb, tpq.train_pq(pts, 16, n_iters=8, seed=0))
    # validations and a codebook shrunk to the row count, as in JAX
    with pytest.raises(ValueError):
        tpq.train_pq(np.zeros((10, 15), np.float32), 4)
    with pytest.raises(ValueError):
        tpq.train_pq(np.zeros((0, 16), np.float32), 4)
    small = tpq.train_pq(pts[:40, :16], 4, seed=0)
    assert small.shape == (4, 40, 4)
    assert int(tpq.pq_encode(small, pts[:40, :16])[0].max()) < 40


def test_opq_rotation_is_orthogonal_and_beats_pq_on_correlated_data():
    """The data of tests/test_pq.py's OPQ test: 16 latent factors mixed into
    64 dims, so subspaces correlate."""
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((4096, 16)).astype(np.float32)
    mix = rng.standard_normal((16, D)).astype(np.float32)
    pts = (latent @ mix + 0.1 * rng.standard_normal((4096, D))).astype(np.float32)
    q = pts[:16] + 0.05 * rng.standard_normal((16, D)).astype(np.float32)
    truth = np.argsort(((q[:, None] - pts[None]) ** 2).sum(-1), 1)[:, :10]

    def recall(idx):
        ids = idx.search(q, 10, chunk_size=4096)[1].numpy()
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])

    pq = TPQ(D, m=16, compute_dtype="f32", train_iters=10, device="cpu")
    pq.build(pts)
    opq = TPQ(D, m=16, compute_dtype="f32", train_iters=10, opq=True, device="cpu")
    opq.build(pts)
    r = opq.rotation.double()
    assert torch.allclose(r @ r.T, torch.eye(D, dtype=torch.float64), atol=1e-5)
    assert recall(opq) > recall(pq) + 0.03
    rec = opq.vectors()  # un-rotated back to the original basis
    assert ((rec - pts) ** 2).sum(-1).mean() / (pts ** 2).sum(-1).mean() < 0.05


# ------------------------------------------------------------------ index
def _state(idx):
    return {k: np.asarray(v) for k, v in idx.state_dict().items()}


@pytest.fixture(scope="module")
def jax_index():
    pts = clustered(seed=2)
    idx = JPQ(D, m=16, compute_dtype="f32", train_iters=8)
    idx.build(pts)
    return idx, pts


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_jax_index_loads_in_port_and_searches_agree(jax_index, backend):
    jidx, pts = jax_index
    tidx = TPQ.from_state_dict(_state(jidx), device="cpu", backend=backend)
    assert tidx.ntotal == jidx.ntotal and tidx.compute_dtype == "f32" and tidx.is_trained
    np.testing.assert_array_equal(tidx.vectors(), jidx.vectors())
    q = pts[::97] + 0.05
    assert_topk_close(tidx.search(q, 10), jidx.search(q, 10), q, jidx.vectors(), RTOL["f32"])
    mask = np.zeros(len(pts), bool)
    mask[100:900] = True
    ids = assert_topk_close(tidx.search(q, 5, filter_mask=mask),
                            jidx.search(q, 5, filter_mask=mask), q, jidx.vectors(),
                            RTOL["f32"])
    assert mask[ids].all()


def test_pq_index_surface_mirrors_jax():
    """tests/test_pq.py's surface test: build, self-retrieval, streaming add
    with the same codebooks, k > ntotal, the empty index."""
    pts = clustered(seed=3)
    idx = TPQ(D, m=16, compute_dtype="f32", device="cpu")
    idx.build(pts)
    assert idx.ntotal == len(pts) and idx.is_trained
    assert idx._codes.dtype == torch.uint8 and idx._codes.shape[1] == 16
    _, ids = idx.search(pts[:8], 1)
    assert (ids[:, 0].numpy() == np.arange(8)).mean() >= 0.9
    cb = idx.codebooks.clone()
    idx.add(clustered(seed=4, n_clusters=4, per=16))
    assert idx.ntotal == len(pts) + 64 and torch.equal(idx.codebooks, cb)
    _, ids = TPQ(D, m=16, device="cpu").search(pts[:2], 3)
    assert (ids == -1).all()
    small = TPQ(16, m=4, compute_dtype="f32", device="cpu")
    small.add(np.random.default_rng(5).standard_normal((4, 16)).astype(np.float32))
    _, ids = small.search(np.ones((2, 16), np.float32), 9)
    assert ids.shape == (2, 9) and (ids[:, 4:] == -1).all()
    _, ids = small.search(np.ones((1, 16), np.float32), 10_000)  # no k limit
    assert ids.shape == (1, 10_000) and (ids[:, 4:] == -1).all()
    small.reset()  # keeps the codebooks
    assert small.ntotal == 0 and small.is_trained and small.codebooks is not None
    with pytest.raises(ValueError):
        TPQ(65, m=16)
    with pytest.raises(ValueError):
        TPQ(64, m=16, ksub=300)


def test_remove_filter_and_persistence_match_jax(jax_index, tmp_path):
    jidx, pts = jax_index
    jidx = JPQ.from_state_dict(_state(jidx))  # a private copy
    tidx = TPQ.from_state_dict(_state(jidx), device="cpu")
    q = pts[:4]
    assert tidx.remove_ids(np.arange(4)) == jidx.remove_ids(np.arange(4)) == 4
    assert tidx.remove_ids([2, 3, 5]) == jidx.remove_ids([2, 3, 5]) == 1
    assert tidx.nlive == jidx.nlive == len(pts) - 5
    ids = assert_topk_close(tidx.search(q, 3), jidx.search(q, 3), q, jidx.vectors(), 1e-5)
    assert not np.isin(ids, [0, 1, 2, 3, 5]).any()
    with pytest.raises(ValueError):
        tidx.search(q, 3, filter_mask=np.ones(3, bool))
    # both stores save; each package loads the other's file
    for name, idx, cls in (("t", tidx, TStore), ("j", jidx, JStore)):
        store = cls(dimension=D, index_path=tmp_path / f"{name}.idx", index=idx,
                    **({"device": "cpu"} if cls is TStore else {}))
        store.doc_ids = list(range(idx.ntotal))
        store.save_index()
    t_from_j = TStore(dimension=D, index_path=tmp_path / "j.idx", device="cpu")
    j_from_t = JStore(dimension=D, index_path=tmp_path / "t.idx")
    assert isinstance(t_from_j.index, TPQ) and t_from_j.index.nlive == jidx.nlive
    assert isinstance(j_from_t.index, JPQ) and j_from_t.index.nlive == tidx.nlive
    for a, b in ((t_from_j, j_from_t),):
        da, ia = a.search(q, k=5)
        db_, ib = b.search(q, k=5)
        assert ia == ib
        for x, y in zip(da, db_):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-3)


def test_port_index_opq_state_loads_in_jax():
    pts = clustered(seed=6, n_clusters=8, per=64)
    tidx = TPQ(D, m=8, compute_dtype="f32", opq=True, train_iters=6, device="cpu")
    tidx.build(pts)
    jidx = JPQ.from_state_dict(_state(tidx))
    assert jidx.rotation is not None
    np.testing.assert_allclose(jidx.vectors(), tidx.vectors(), rtol=1e-5, atol=1e-5)
    q = pts[::50] + 0.1
    assert_topk_close(tidx.search(q, 10), jidx.search(q, 10), q, tidx.vectors(), 1e-5)
    again = TPQ.from_state_dict(_state(jidx), device="cpu")
    assert torch.equal(again.search(q, 10)[1], tidx.search(q, 10)[1])


def test_cpu_pq_index_never_counts_a_launch(jax_index):
    jidx, pts = jax_index
    tidx = TPQ.from_state_dict(_state(jidx), device="cpu", backend="pallas")
    before = PD.decode.launches
    tidx.search(pts[:4], 5)
    assert PD.decode.launches == before
