"""rag_faiss_embedding_tpu_torch.ops.distance vs the JAX ops/distance.py.

The same numpy inputs (from a seeded generator) go through both. Tolerances:
float32 distances rtol 1e-5 / atol 1e-4 (both accumulate in f32, in
different orders); bf16 storage widens exactly to f32 on both sides, so the
same bound holds for it. Ids must be identical: these inputs have no
near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.ops import distance as JD
from rag_faiss_embedding_tpu_torch.ops import distance as TD

RTOL, ATOL = 1e-5, 1e-4


def _both(q, db, k, dtype="float32", **kw):
    """Run both packages' exact_search on the same numpy inputs."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jv, ji = JD.exact_search(jnp.asarray(q, jdt), jnp.asarray(db, jdt), k, **kw)
    tkw = dict(kw)
    if tkw.get("dead") is not None:
        tkw["dead"] = torch.from_numpy(np.asarray(tkw["dead"]))
    tv, ti = TD.exact_search(torch.from_numpy(q).to(tdt),
                             torch.from_numpy(db).to(tdt), k, **tkw)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(j, t):
    (jv, ji), (tv, ti) = j, t
    np.testing.assert_array_equal(ti, ji)
    assert ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("n,chunk", [(300, 64), (257, 1000)])
def test_exact_search_matches_jax(rng, dtype, metric, n, chunk):
    q = rng.standard_normal((6, 24)).astype(np.float32)
    db = rng.standard_normal((n, 24)).astype(np.float32)
    _assert_same(*_both(q, db, 7, dtype, metric=metric, chunk_size=chunk))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_exact_search_n_valid_and_dead(rng, metric):
    q = rng.standard_normal((4, 16)).astype(np.float32)
    db = rng.standard_normal((200, 16)).astype(np.float32)
    dead = np.zeros(200, bool)
    dead[rng.choice(150, 40, replace=False)] = True
    j, t = _both(q, db, 9, metric=metric, n_valid=150, dead=dead,
                 chunk_size=64)
    _assert_same(j, t)
    assert not np.isin(t[1], np.nonzero(dead)[0]).any()
    assert (t[1] < 150).all()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_k_larger_than_live_rows(rng, metric):
    """k > n pads with -1; k > n_valid inside a buffer gives -1 too."""
    q = rng.standard_normal((3, 8)).astype(np.float32)
    db = rng.standard_normal((5, 8)).astype(np.float32)
    j, t = _both(q, db, 9, metric=metric)
    _assert_same(j, t)
    assert (t[1][:, 5:] == -1).all()
    fill = np.inf if metric == "L2" else -np.inf
    assert (t[0][:, 5:] == fill).all()
    j, t = _both(q, np.concatenate([db, db]), 6, metric=metric, n_valid=4)
    _assert_same(j, t)
    assert (t[1][:, 4:] == -1).all()


def test_ties_go_to_lowest_index(rng):
    """torch.topk does not break ties toward the lowest index; the port's
    selection must (FAISS and lax.top_k parity)."""
    row = rng.standard_normal(16).astype(np.float32)
    db = np.stack([row] * 4100)
    j, t = _both(row[None], db, 5, chunk_size=1024)
    _assert_same(j, t)
    np.testing.assert_array_equal(t[1][0], [0, 1, 2, 3, 4])
    vals, idx = TD.small_topk(torch.zeros(1, 4096), 5)
    np.testing.assert_array_equal(idx.numpy()[0], [0, 1, 2, 3, 4])


@pytest.mark.parametrize("k", [1, 4, 12])
def test_small_topk_matches_jax(rng, k):
    # integers in a narrow range: many ties
    x = rng.integers(-5, 5, size=(7, 12)).astype(np.float32)
    jv, ji = JD.small_topk(jnp.asarray(x), k)
    tv, ti = TD.small_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_topk_matches_jax(rng):
    va = np.sort(rng.integers(0, 6, (5, 4)).astype(np.float32), 1)[:, ::-1].copy()
    vb = np.sort(rng.integers(0, 6, (5, 4)).astype(np.float32), 1)[:, ::-1].copy()
    ia = rng.integers(0, 100, (5, 4)).astype(np.int32)
    ib = rng.integers(100, 200, (5, 4)).astype(np.int32)
    jv, ji = JD.merge_topk(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 4)
    tv, ti = TD.merge_topk(*(torch.from_numpy(a) for a in (va, ia, vb, ib)), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pairwise_matches_jax(rng):
    q = rng.standard_normal((5, 32)).astype(np.float32)
    db = rng.standard_normal((40, 32)).astype(np.float32)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    np.testing.assert_allclose(
        TD.pairwise_l2(tq, tdb).numpy(),
        np.asarray(JD.pairwise_l2(jnp.asarray(q), jnp.asarray(db))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TD.pairwise_ip(tq, tdb).numpy(),
        np.asarray(JD.pairwise_ip(jnp.asarray(q), jnp.asarray(db))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TD.sqnorms(tdb).numpy(), np.asarray(JD.sqnorms(jnp.asarray(db))),
        rtol=1e-6)


def test_approx_selector_is_not_ported(rng, tmp_path):
    """The "approx" selector is ported: ``exact_search(selector="approx")``
    equals JAX's (``lax.approx_max_k`` is an exact top-k off the TPU) and the
    exact selector, whatever ``recall_target``; a ``VectorStore`` with it
    searches as JAX's does; an unknown selector raises."""
    from rag_faiss_embedding_tpu.index import VectorStore as JStore
    from rag_faiss_embedding_tpu_torch.index import VectorStore

    db = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    for metric in ("L2", "IP"):
        j, t = _both(q, db, 7, metric=metric, chunk_size=128, selector="approx",
                     recall_target=0.9)
        _assert_same(j, t)
        _assert_same(j, _both(q, db, 7, metric=metric, chunk_size=128)[1])
    with pytest.raises(ValueError, match="selector"):
        TD.exact_search(db[:1], db, 2, selector="rerank")
    tstore = VectorStore(dimension=16, selector="approx",
                         index_path=tmp_path / "t.tpu", device="cpu")
    jstore = JStore(dimension=16, selector="approx", index_path=tmp_path / "j.tpu")
    for store in (tstore, jstore):
        store.add_vectors(db, list(range(300)))
    assert tstore.index.selector == "approx"
    (td, ti), (jd, ji) = tstore.search(q, k=5), jstore.search(q, k=5)
    assert ti == ji
    np.testing.assert_allclose(np.array(td), np.array(jd), rtol=RTOL, atol=ATOL)