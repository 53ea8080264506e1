"""The fused union-block top-k prototype (K5) vs the JAX script.

``benchmarks/pallas_fused_proto.py`` runs its whole 1M benchmark when it is
imported, so its functions ``kern``, ``fused_pallas_chunks`` and
``search_pallas`` are loaded from the untouched file by ``ast`` into a
namespace with small constants and ``pallas_call(interpret=True)``.

- ``block_topk_reference`` (the plain version of ``csrc/fused_proto.cu``)
  against the JAX kernel on the same numpy inputs: ids equal on every slot
  above NEG_INF (the JAX ids below it are arbitrary), scores to rtol 1e-3 /
  atol 1e-3 (bf16 rows, two summation orders of the same exact products);
  cases with dead rows, a spill row twice in one cell, a cell with fewer
  than kp live rows.
- The port's ``benchmarks.fused_proto.search`` on a JAX-built IVF index
  cross-loaded through its npz state: the JAX ids except at near-ties (each
  id carries its own float64 distance), recall within 0.005.

The ``cuda`` tests hold the kernel to its plain version on the card (the
tensor-core block to float32 rounding, ids carrying their own float64
scores; the FMA block bit for bit) and skip without one. They import no JAX:
``python -m pytest tests/test_torch_fused_proto.py -m cuda --noconftest -q``.
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.benchmarks import fused_proto as B
from rag_faiss_embedding_tpu_torch.ops import fused_proto as FP
from rag_faiss_embedding_tpu_torch.ops.distance import NEG_INF

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "benchmarks" / "pallas_fused_proto.py"
RTOL, ATOL = 1e-3, 1e-3
NLIST, WINDOW, D = 12, 128, 128


def load_script_functions(path, names, constants):
    """Exec only the named top-level functions of ``path`` in a namespace
    holding ``constants``, with Pallas calls in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from rag_faiss_embedding_tpu.ops.distance import NEG_INF as J_NEG_INF
    from rag_faiss_embedding_tpu.ops.pallas_scan import _extract_topk

    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    shim = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = dict(jax=jax, jnp=jnp, lax=lax, pl=shim, pltpu=pltpu, NEG_INF=J_NEG_INF,
              _extract_topk=_extract_topk, **constants)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _jax_proto(**constants):
    pytest.importorskip("jax")
    return load_script_functions(SCRIPT, ("kern", "fused_pallas_chunks", "search_pallas"),
                                 constants)


def _inputs(rng, chunks=2, qc=16, ucap=8, nlist=NLIST, window=WINDOW, d=D, dead_frac=0.2):
    """bf16-representable rows and queries (as float32), a dead sentinel
    block, some dead slots, and per-chunk sorted unions."""
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    codes = bf(rng.standard_normal((nlist + 1, window, d)).astype(np.float32))
    ids = rng.permutation((nlist + 1) * window).astype(np.int32).reshape(nlist + 1, window)
    ids[rng.random(ids.shape) < dead_frac] = -1
    ids[nlist] = -1
    codes[nlist] = 0.0
    sq = (codes.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    u_all = np.stack([np.sort(rng.choice(nlist + 1, ucap, replace=False))
                      for _ in range(chunks)]).astype(np.int32)
    qs = bf(rng.standard_normal((chunks, qc, d)).astype(np.float32))
    return qs, u_all, codes, sq, ids


def _jax_block_topk(ns, inp):
    import jax.numpy as jnp

    qs, u_all, codes, sq, ids = inp
    nb1, window = ids.shape
    v, i = ns["fused_pallas_chunks"](
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(u_all), jnp.asarray(codes, jnp.bfloat16),
        jnp.asarray(sq).reshape(nb1, 1, window), jnp.asarray(ids).reshape(nb1, 1, window))
    return np.asarray(v), np.asarray(i)


def _port(inp, fn=FP.block_topk_reference, device="cpu", **kw):
    qs, u_all, codes, sq, ids = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                 for a in inp)
    v, i = fn(qs.bfloat16(), u_all, codes.bfloat16(), sq, ids, **kw)
    return v.cpu().numpy(), i.cpu().numpy()


def _same_cells(tv, ti, jv, ji):
    """Slots above NEG_INF agree (ids exactly, scores to the tolerance);
    the rest are NEG_INF / -1 on the port's side."""
    live = jv > NEG_INF
    np.testing.assert_array_equal(tv > NEG_INF, live)
    np.testing.assert_array_equal(ti[live], ji[live])
    np.testing.assert_allclose(tv[live], jv[live], rtol=RTOL, atol=ATOL)
    assert (ti[~live] == -1).all() and (tv[~live] == NEG_INF).all()


def _spill_twice(inp):
    """Give chunk 0's first cell one row twice (same id, same row, in its
    first and second blocks), close to query 0 so that it is in its top."""
    qs, u_all, codes, sq, ids = (a.copy() for a in inp)
    a, b = u_all[0, 0], u_all[0, 1]
    codes[a, 3] = qs[0, 0]
    sq[a, 3] = (codes[a, 3].astype(np.float64) ** 2).sum()
    ids[a, 3] = 999_999
    codes[b, 5], sq[b, 5], ids[b, 5] = codes[a, 3], sq[a, 3], ids[a, 3]
    return qs, u_all, codes, sq, ids


def _sparse_cell(inp, live=3):
    """Chunk 0's first cell holds only ``live`` live rows."""
    qs, u_all, codes, sq, ids = (a.copy() for a in inp)
    cell = u_all[0, :4]
    ids[cell] = -1
    ids[cell[1], :live] = np.arange(live) + 500_000
    return qs, u_all, codes, sq, ids


CASES = {"dead rows": lambda inp: inp, "spill row twice in a cell": _spill_twice,
         "fewer live rows than kp": _sparse_cell}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_pallas(rng, case):
    ns = _jax_proto(QC=16, UCAP=8, BB=4, KP=10, DIM=D, K=10, window=WINDOW, nlist=NLIST)
    inp = CASES[case](_inputs(rng))
    jv, ji = _jax_block_topk(ns, inp)
    tv, ti = _port(inp, bb=4, kp=10)
    assert tv.shape == ti.shape == jv.shape == (2, 2, 16, 10)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    _same_cells(tv, ti, jv, ji)
    for row in ti.reshape(-1, 10):  # an id comes back once per cell
        got = row[row >= 0]
        assert len(set(got.tolist())) == len(got)
    if case == "spill row twice in a cell":
        assert ti[0, 0, 0, 0] == 999_999  # query 0's own row, once
        assert ((ti == 999_999).sum(-1) <= 1).all()
    if case == "fewer live rows than kp":
        assert ((ti[0, 0] >= 0).sum(-1) == 3).all()


def test_extract_topk_takes_ids_once_and_ties_low():
    s = torch.tensor([[5.0, 7.0, 7.0, 7.0, NEG_INF, 1.0]])
    g = torch.tensor([[4, 9, 2, 9, -1, 3]], dtype=torch.int32)
    v, i = FP.extract_topk(s, g, 5)
    assert i.tolist() == [[2, 9, 4, 3, -1]]
    assert v.tolist()[0][:4] == [7.0, 7.0, 5.0, 1.0] and v[0, 4] == NEG_INF


def test_kp_and_shape_checks(rng):
    inp = _inputs(rng)
    for kp in (0, FP.KP_MAX + 1):
        with pytest.raises(ValueError, match="kp"):
            _port(inp, bb=4, kp=kp)
    with pytest.raises(ValueError, match="multiple of bb"):
        _port(inp, bb=3, kp=10)
    tv, ti = _port(inp, bb=4, kp=FP.KP_MAX)
    assert ti.shape == (2, 2, 16, FP.KP_MAX)


def test_cpu_tensor_takes_the_plain_version(rng):
    inp = _inputs(rng, chunks=1)
    before = FP.block_topk.launches
    a = _port(inp, fn=FP.block_topk, bb=4, kp=5)
    assert FP.block_topk.launches == before
    b = _port(inp, bb=4, kp=5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------ the search
@pytest.fixture(scope="module")
def cross_loaded():
    """A JAX-built bf16 IVF index over 4,096 rows of 128 dims (nlist 32,
    reassign), its npz state loaded by the port, and 64 queries."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rag_faiss_embedding_tpu.index.ivf import IVFFlatIndex as JIVF
    from rag_faiss_embedding_tpu_torch.index.ivf import IVFFlatIndex as TIVF

    rng = np.random.default_rng(1)
    centers = rng.standard_normal((64, 128)).astype(np.float32)
    db = centers[rng.integers(0, 64, 4096)] + 0.7 * rng.standard_normal((4096, 128)).astype(
        np.float32)
    q = (db[:64] + 0.3 * rng.standard_normal((64, 128))).astype(np.float32)
    jidx = JIVF(128, nlist=32, dtype="bfloat16", balance="reassign", train_iters=5)
    jidx.build(jnp.asarray(db))
    tidx = TIVF.from_state_dict({k: np.array(v) for k, v in jidx.state_dict().items()},
                                device="cpu")
    d2 = ((q.astype(np.float64)[:, None] - db.astype(np.float64)[None]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10]
    return jidx, tidx, db, q, d2, truth


def _recall(ids, truth):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


def test_search_matches_pallas_on_cross_loaded_index(cross_loaded):
    import jax.numpy as jnp

    jidx, tidx, db, q, d2, truth = cross_loaded
    nlist, window = jidx.nlist, jidx._window
    ns = _jax_proto(QC=16, UCAP=16, BB=4, KP=10, DIM=128, K=10, window=window, nlist=nlist)
    jv, ji = ns["search_pallas"](
        jnp.asarray(q), jidx._cent_store, jidx._cent_sq,
        jidx._sorted_vecs.reshape(nlist + 1, window, 128),
        jidx._sorted_sq.reshape(nlist + 1, 1, window),
        jidx._sorted_ids.reshape(nlist + 1, 1, window))
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = B.search(torch.from_numpy(q), tidx, ucap=16, qc=16, bb=4, kp=10, k=10)
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == ti.shape == (64, 10) and ti.dtype == np.int32
    assert (ti >= 0).all() and np.isfinite(tv).all()
    # each port id carries its own distance, recomputed in float64 from the
    # stored bf16 row and norm: ||q||^2 - 2 bf16(q).x + ||x||^2; the
    # tolerance is float32 rounding of terms up to max ||q||^2 + ||x||^2
    ids, slots = tidx._sorted_ids.numpy(), np.arange(tidx._sorted_ids.numel())
    slot_of = np.full(db.shape[0], -1)
    slot_of[ids[ids >= 0]] = slots[ids >= 0]
    s = slot_of[ti]
    rows = tidx._sorted_vecs.float().numpy().astype(np.float64)[s]
    qb = torch.from_numpy(q).bfloat16().double().numpy()
    q64 = q.astype(np.float64)
    own = ((q64 ** 2).sum(-1)[:, None] - 2 * np.einsum("qd,qkd->qk", qb, rows)
           + tidx._sorted_sq.numpy().astype(np.float64)[s])
    atol = 1e-5 * float((q64 ** 2).sum(-1).max() + tidx._sorted_sq.max())
    np.testing.assert_allclose(tv, np.maximum(own, 0), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=atol)
    for r, c in np.argwhere(ti != ji):  # ids differ only at near-ties
        assert abs(tv[r, c] - jv[r, c]) <= atol + 1e-5 * abs(jv[r, c])
    t_rec, j_rec = _recall(ti, truth), _recall(ji, truth)
    assert abs(t_rec - j_rec) <= 0.005
    assert t_rec >= 0.95


@pytest.mark.parametrize("kw,match", [
    (dict(ucap=16, qc=24, bb=4), "multiple of qc"),
    (dict(ucap=18, qc=16, bb=4), "multiple of bb"),
    (dict(ucap=64, qc=16, bb=4), "exceeds nlist"),
])
def test_search_shape_errors(cross_loaded, kw, match):
    _, tidx, _, q, _, _ = cross_loaded
    with pytest.raises(ValueError, match=match):
        B.search(torch.from_numpy(q), tidx, kp=10, k=10, **kw)


def test_search_on_cpu_launches_nothing(cross_loaded):
    _, tidx, _, q, _, truth = cross_loaded
    before = FP.block_topk.launches
    _, ids = B.search(torch.from_numpy(q[:32]), tidx, ucap=16, qc=16, bb=4, kp=10, k=10)
    assert FP.block_topk.launches == before
    assert B.recall_at(ids, torch.from_numpy(truth[:32])) >= 0.95


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_close_to_plain(inp, kv, ki, pv, pi, rtol=1e-4):
    """The card's rule for the tensor-core block against the plain version
    (they sum the same exact bf16 products in different orders): the same
    slots filled, scores within rtol x (max ||q||^2 + max ||x||^2) + rtol x
    |score|, every list sorted with distinct ids, and every kernel id
    carrying its own float64 score in its cell (the best of its rows there:
    a spill row's copies are the same row), so ids differ only at
    near-ties."""
    qs, u_all, codes, sq, ids = inp
    chunks, nb, qc, kp = kv.shape
    ok = ki >= 0
    np.testing.assert_array_equal(ok, pi >= 0)
    assert (kv[~ok] == NEG_INF).all()
    q64 = qs.astype(np.float64)
    atol = rtol * float((q64 ** 2).sum(-1).max() + sq[ids >= 0].max())
    np.testing.assert_allclose(kv[ok], pv[ok], rtol=rtol, atol=atol)
    assert (kv[..., 1:] <= kv[..., :-1]).all()
    srt = np.sort(np.where(ok, ki, -1 - np.arange(kp)), axis=-1)
    assert (srt[..., 1:] != srt[..., :-1]).all()  # an id once per cell
    bb = u_all.shape[1] // nb
    for c in range(chunks):
        blocks = u_all[c].reshape(nb, bb)
        rows = codes[blocks].astype(np.float64).reshape(nb, -1, codes.shape[-1])
        rid = ids[blocks].reshape(nb, -1)
        s = 2 * np.einsum("qd,brd->bqr", q64[c], rows) - sq[blocks].reshape(nb, 1, -1)
        own = np.where(rid[:, None, None, :] == ki[c][..., None],
                       s[:, :, None, :], -np.inf).max(-1)
        np.testing.assert_allclose(kv[c][ok[c]], own[ok[c]], rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("chunks,qc,ucap,bb,kp,window,d", [
    (2, 16, 8, 4, 10, 128, 128), (1, 40, 12, 3, 1, 64, 384), (3, 33, 16, 16, 32, 256, 384),
    (4, 256, 32, 16, 10, 256, 384), (1, 130, 8, 4, 10, 64, 72),
])
def test_kernel_matches_plain_on_card(rng, cuda, case, chunks, qc, ucap, bb, kp, window, d):
    """Kernel vs plain on the same card tensors. The tensor-core block sums
    the exact bf16 products in another order than the plain version, so it
    is held to ``_assert_close_to_plain``; D = 72 (not a multiple of 16)
    takes the FMA block, which sums in the plain version's order: bit for
    bit. A chunk of 256 or 130 queries spans two tensor-core query tiles."""
    nlist = max(ucap + 2, 12)
    inp = CASES[case](_inputs(rng, chunks=chunks, qc=qc, ucap=ucap, nlist=nlist,
                              window=window, d=d))
    before = FP.block_topk.launches
    kv, ki = _port(inp, fn=FP.block_topk, device=cuda, bb=bb, kp=kp)
    torch.cuda.synchronize()
    assert FP.block_topk.launches == before + 1
    pv, pi = _port(inp, device=cuda, bb=bb, kp=kp)
    tc = FP.uses_tensor_cores(torch.cuda.current_device(), d)
    assert tc == (d % 16 == 0)
    if tc:
        _assert_close_to_plain(inp, kv, ki, pv, pi)
    else:
        np.testing.assert_array_equal(kv.view(np.int32), pv.view(np.int32))
        np.testing.assert_array_equal(ki, pi)
    if case == "spill row twice in a cell":
        assert ki[0, 0, 0, 0] == 999_999 and ((ki == 999_999).sum(-1) <= 1).all()
    if case == "fewer live rows than kp" and bb <= 4:  # the cell of the killed blocks
        assert ((ki[0, 0] >= 0).sum(-1) == min(3, kp)).all()
