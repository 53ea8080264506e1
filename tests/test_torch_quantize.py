"""The int8 tier's ops (``ops/quantize``) vs the JAX package's.

The same seeded numpy rows are quantized by both packages (the codes and
scales are bit-identical: both round half to even) and searched by both.
Tolerances: ``int8_search`` takes its int32 dots exactly in both packages
and the same float order after them, so ids are equal and scores within
1 float32 ulp (they agree bit for bit on these inputs; the ulp is room for
XLA's fusion). ``int8_rerank_search`` re-scores its candidates with a float32
einsum summed in another order: ids equal (no near-ties in these inputs),
values to rtol 1e-5 / atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.ops import distance as JD
from rag_faiss_embedding_tpu.ops import quantize as JQ
from rag_faiss_embedding_tpu_torch.ops import quantize as TQ

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, nq, d, n=300):
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    jd, js = JQ.quantize_rows(jnp.asarray(db))
    jq, jqs = JQ.quantize_rows(jnp.asarray(q))
    jax_in = dict(q=jnp.asarray(q), q_i8=jq, q_scale=jqs, q_sq=JD.sqnorms(jnp.asarray(q)),
                  db_i8=jd, db_scale=js, db_sq=JD.sqnorms(jnp.asarray(db)),
                  shadow=jnp.asarray(db).astype(jnp.bfloat16))
    port_in = {k: _t(v) for k, v in jax_in.items() if k != "shadow"}
    port_in["shadow"] = torch.from_numpy(db).bfloat16()
    return db, q, jax_in, port_in


def test_quantize_rows_bit_identical(rng):
    x = rng.standard_normal((64, 20)).astype(np.float32)
    x[3] = 0.0  # an all-zero row keeps its floor scale
    jc, js = JQ.quantize_rows(jnp.asarray(x))
    tc, ts = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TQ.dequantize(tc, ts).numpy(),
                                  np.asarray(JQ.dequantize(jc, js)))


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("nq", [1, 33])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_int8_search_matches_jax(rng, d, nq, metric, selector):
    """Several chunks (a short last one), rows past ``n_valid``, dead rows,
    and k above the rows of one chunk."""
    _, _, j, t = _inputs(rng, nq, d)
    dead = rng.random(300) < 0.2
    for k, chunk, n_valid in ((7, 128, 250), (40, 32, 300), (3, 1024, 300)):
        kw = dict(metric=metric, n_valid=n_valid, chunk_size=chunk, selector=selector)
        args = ("q_i8", "q_scale", "q_sq", "db_i8", "db_scale", "db_sq")
        jv, ji = JQ.int8_search(*(j[a] for a in args), k, dead=jnp.asarray(dead), **kw)
        tv, ti = TQ.int8_search(*(t[a] for a in args), k, dead=torch.from_numpy(dead), **kw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv), maxulp=1)
        assert not np.isin(ti.numpy(), np.nonzero(dead)[0]).any()
        assert (ti.numpy() < n_valid).all()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_int8_search_k_above_rows_pads(rng, metric):
    _, _, j, t = _inputs(rng, 3, 16, n=10)
    args = ("q_i8", "q_scale", "q_sq", "db_i8", "db_scale", "db_sq")
    kw = dict(metric=metric, n_valid=8, chunk_size=4)
    jv, ji = JQ.int8_search(*(j[a] for a in args), 12, **kw)
    tv, ti = TQ.int8_search(*(t[a] for a in args), 12, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv), maxulp=1)
    assert (ti.numpy()[:, 8:] == -1).all()
    assert np.isinf(tv.numpy()[:, 8:]).all()


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("nq", [1, 33])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("with_shadow", [True, False])
def test_int8_rerank_search_matches_jax(rng, d, nq, metric, with_shadow):
    """Candidates per chunk with no cross-chunk merge (the chunking sets the
    candidate set), a short last chunk, dead rows re-masked before stage 2,
    rows past ``n_valid``, and the dequantized codes without a shadow."""
    _, _, j, t = _inputs(rng, nq, d)
    dead = rng.random(300) < 0.2
    for k, chunk, n_valid, cand in ((7, 128, 250, 16), (10, 64, 300, 20), (5, 1024, 300, 400)):
        kw = dict(metric=metric, n_valid=n_valid, chunk_size=chunk, cand_per_chunk=cand)
        args = ("q", "q_i8", "q_scale", "q_sq", "db_i8", "db_scale", "db_sq")
        jv, ji = JQ.int8_rerank_search(*(j[a] for a in args),
                                       j["shadow"] if with_shadow else None, k,
                                       dead=jnp.asarray(dead), **kw)
        tv, ti = TQ.int8_rerank_search(*(t[a] for a in args),
                                       t["shadow"] if with_shadow else None, k,
                                       dead=torch.from_numpy(dead), **kw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
        assert not np.isin(ti.numpy(), np.nonzero(dead)[0]).any()


def test_rerank_recovers_exact_order(rng):
    """The bf16 shadow's re-score puts the exact float32 top-10 back where
    the quantized scores alone miss some of it (both packages)."""
    db, q, j, t = _inputs(rng, 20, 64, n=2000)
    exact = np.argsort(((q[:, None] - db[None]) ** 2).sum(-1), axis=1)[:, :10]
    args = ("q_i8", "q_scale", "q_sq", "db_i8", "db_scale", "db_sq")
    kw = dict(metric="L2", n_valid=2000, chunk_size=1024)
    _, plain = TQ.int8_search(*(t[a] for a in args), 10, **kw)
    _, rr = TQ.int8_rerank_search(t["q"], *(t[a] for a in args), t["shadow"], 10,
                                  cand_per_chunk=32, **kw)
    recall = lambda ids: np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, exact)])
    assert recall(rr.numpy()) >= recall(plain.numpy())
    assert recall(rr.numpy()) >= 0.99


def test_int8_dots_reference_is_exact(rng):
    """The plain product of the codes equals the int64 product, also past
    the widest D whose sums float32 holds exactly (float64 there)."""
    for d in (20, 384, 1040, 1100):
        a = torch.from_numpy(rng.integers(-127, 128, (5, d)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (9, d)).astype(np.int8))
        a[0], b[0] = 127, 127  # the largest sum
        want = a.long() @ b.long().T
        got = TQ.int8_dots(a, b)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), want)
    assert TQ.int8_dots.launches == 0  # CPU tensors take the plain product
