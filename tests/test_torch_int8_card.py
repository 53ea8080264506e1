"""The int8 tier on the card: the int8 product and both int8 indexes.

Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so on the card they run with
``python -m pytest tests/test_torch_int8_card.py -m cuda --noconftest -q``.

- ``torch._int_mm`` (``ops/quantize.int8_dots``) against the plain product
  of the codes: bit for bit (every sum is an exact integer).
- A card index against the same index on the CPU: ids equal except at
  near-ties, values within rtol 1e-5 x (max ||q||^2 + max ||x||^2) (the
  norms and the rerank's float32 re-score are summed in other orders).
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex
from rag_faiss_embedding_tpu_torch.ops import quantize as Q

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch._int_mm runs on the card)")
    return torch.device("cuda")


def _randint8(g, *shape):
    return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)


@pytest.mark.cuda
def test_int_mm_matches_plain_product_on_card(cuda):
    """Q 1 / 16 / 17 / 1,024 (rows padded past 16), D 384 / 20 (zero columns
    to a multiple of 8), N a multiple of 8 and not; one launch a call."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for d in (384, 20):
        for n in (4096, 4093):
            db = _randint8(g, n, d)
            for nq in (1, 16, 17, 1024):
                q = _randint8(g, nq, d)
                before = Q.int8_dots.launches
                got = Q.int8_dots(q, db)
                assert Q.int8_dots.launches == before + 1
                assert torch.equal(got, Q.int8_dots_reference(q, db))


@pytest.mark.cuda
def test_int_mm_takes_the_rows_without_a_copy(cuda):
    """A 524,288-row chunk of a 1M x 384 buffer goes to ``_int_mm`` as its
    transposed view: the call allocates the int32 result, not a copy of the
    201 MB of rows."""
    g = torch.Generator(device="cuda").manual_seed(1)
    big = _randint8(g, 1 << 20, 384)
    q = big[:1].clone()
    chunk = big[: 1 << 19]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = Q.int8_dots(q, chunk)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < chunk.numel()
    assert torch.equal(got, Q.int8_dots_reference(q, chunk))


def _same_topk(card, cpu, q, rows, k):
    """``card`` (values, ids) against ``cpu``'s: values within the
    tolerance, ids equal except where a value ties its neighbour."""
    kv, ki = (t.cpu().numpy() for t in card)
    cv, ci = (t.numpy() for t in cpu)
    atol = RTOL * float((q.astype(np.float64) ** 2).sum(1).max()
                        + (rows.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_array_equal(np.isfinite(kv), np.isfinite(cv))
    fin = np.isfinite(cv)
    np.testing.assert_allclose(kv[fin], cv[fin], rtol=RTOL, atol=atol)
    for r, c in zip(*np.nonzero(ki != ci)):
        near = np.isclose(cv[r], cv[r, c], rtol=RTOL, atol=atol).sum() > 1
        assert near or c == k - 1, (r, c)


@pytest.mark.cuda
@pytest.mark.parametrize("selector", ["exact", "approx", "rerank"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_card_int8_flat_index_matches_cpu(cuda, selector, metric):
    """An int8 ``FlatIndex`` on the card (tombstones and a filter included)
    against the same index moved to the CPU; the card's searches go through
    ``_int_mm``."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5000, 384)).astype(np.float32)
    card = FlatIndex(384, metric=metric, dtype="int8", selector=selector, device=cuda)
    card.add(vecs)
    card.remove_ids([0, 17, 4999])
    cpu = FlatIndex.from_state_dict(card.state_dict(), selector=selector, device="cpu")
    allow = rng.random(5000) < 0.5
    for nq in (1, 33):
        q = rng.standard_normal((nq, 384)).astype(np.float32)
        for kw in ({}, {"filter_mask": allow}):
            before = Q.int8_dots.launches
            out = card.search(q, 10, **kw)
            torch.cuda.synchronize()
            assert Q.int8_dots.launches > before
            _same_topk(out, cpu.search(q, 10, **kw), q, vecs, 10)
            assert not np.isin(out[1].cpu().numpy(), [0, 17, 4999]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("rerank", [True, False])
def test_card_int8_ivf_index_matches_cpu(cuda, rerank):
    """A dense int8 ``IVFFlatIndex`` built on the card (with and without its
    bf16 shadow, a streamed pending tier and removed rows) against the same
    state searched on the CPU."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((64, 128)).astype(np.float32)
    pts = (centers[rng.integers(0, 64, 6000)]
           + 0.4 * rng.standard_normal((6000, 128))).astype(np.float32)
    q = (pts[::97] + 0.2 * rng.standard_normal((len(pts[::97]), 128))).astype(np.float32)
    card = IVFFlatIndex(128, nlist=64, dtype="int8", rerank=rerank, train_iters=5,
                        device=cuda)
    card.build(pts)
    card.add(pts[:50] + 0.01)
    card.remove_ids(np.arange(0, 6000, 13))
    assert (card._sorted_shadow is not None) == rerank
    cpu = IVFFlatIndex.from_state_dict(card.state_dict(), device="cpu")
    for nprobe in (4, 64):
        before = Q.int8_dots.launches
        out = card.search(q, 10, nprobe=nprobe)
        torch.cuda.synchronize()
        assert Q.int8_dots.launches > before
        _same_topk(out, cpu.search(q, 10, nprobe=nprobe), q, pts, 10)
    with pytest.raises(ValueError, match="pallas"):
        card.backend = "pallas"
        card.search(q, 10)
