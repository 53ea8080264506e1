"""The port's IVF index on the card: builds repeat, and the kernel route
agrees with the same index searched on the CPU through the kernel's plain
version.

Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so on the card they run with
``python -m pytest tests/test_torch_ivf_card.py -m cuda --noconftest -q``.
Tolerance: distances to rtol 1e-4 / atol 1e-3 (float32 sums in different
orders; D = 128, unit-normal data); ids may differ only where the distances
agree.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex
from rag_faiss_embedding_tpu_torch.ops import union_scan as U

RTOL, ATOL = 1e-4, 1e-3
D = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _data(seed=0, n_modes=64, per=96, metric="L2"):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, D)).astype(np.float32)
    pts = (centers[rng.integers(0, n_modes, n_modes * per)]
           + 0.4 * rng.standard_normal((n_modes * per, D))).astype(np.float32)
    q = (pts[::37] + 0.2 * rng.standard_normal((len(pts[::37]), D))).astype(np.float32)
    if metric == "IP":
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return pts, q


def _agree(card, cpu):
    cv, ci = (t.cpu().numpy() for t in card)
    pv, pi = (t.cpu().numpy() for t in cpu)
    np.testing.assert_allclose(cv, pv, rtol=RTOL, atol=ATOL)
    diff = ci != pi
    assert np.allclose(cv[diff], pv[diff], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_ivf_build_is_reproducible_on_card(cuda):
    """Two builds of the same rows with the same seed give the same index
    (k-means sums without float atomics)."""
    pts, _ = _data()
    a = IVFFlatIndex(D, nlist=64, balance="reassign", train_iters=8, device=cuda)
    b = IVFFlatIndex(D, nlist=64, balance="reassign", train_iters=8, device=cuda)
    a.build(pts)
    b.build(pts)
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a._sorted_ids, b._sorted_ids) and a._window == b._window


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("metric,dtype", [("L2", "float32"), ("L2", "bfloat16"),
                                          ("IP", "float32")])
@pytest.mark.parametrize("nq,k", [(1, 10), (40, 10), (40, 30)])
def test_ivf_kernel_route_matches_cpu_plain_on_card(cuda, variant, metric, dtype, nq, k):
    pts, q = _data(metric=metric)
    cpu = IVFFlatIndex(D, nlist=64, metric=metric, dtype=dtype, balance="reassign",
                       train_iters=8, device="cpu", backend="pallas",
                       pallas_variant=variant)
    cpu.build(pts)
    card = IVFFlatIndex.from_state_dict(cpu.state_dict(), device=cuda,
                                        pallas_variant=variant)
    assert card.resolved_dispatch(nq, k)["backend"] == "pallas"
    before = U.union_scan.variant_launches[variant]
    out = card.search(q[:nq], k)
    torch.cuda.synchronize()
    assert U.union_scan.variant_launches[variant] == before + 1
    _agree(out, cpu.search(q[:nq], k))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [1, 2])
def test_ivf_remove_ids_filter_and_pending_on_card(cuda, variant):
    """The same removals and streamed adds on a card index and its CPU copy
    (same layout): dead rows stay out, pending rows come back, filtered
    searches agree."""
    pts, q = _data(seed=1)
    cpu = IVFFlatIndex(D, nlist=64, train_iters=8, device="cpu", backend="pallas",
                       pallas_variant=variant)
    cpu.build(pts)
    card = IVFFlatIndex.from_state_dict(cpu.state_dict(), device=cuda,
                                        pallas_variant=variant)
    _, first = card.search(q[:16], 1)
    kill = torch.unique(first[:, 0]).cpu().numpy()
    extra = np.random.default_rng(2).standard_normal((20, D)).astype(np.float32)
    for idx in (card, cpu):
        assert idx.remove_ids(kill) == len(kill)
        idx.add(extra)
    v, ids = card.search(q[:16], 10)
    assert not np.isin(ids.cpu().numpy(), kill).any()
    _agree((v, ids), cpu.search(q[:16], 10))
    _, hit = card.search(extra[:4], 1)
    np.testing.assert_array_equal(hit[:, 0].cpu().numpy(), len(pts) + np.arange(4))
    mask = np.random.default_rng(3).random(card.ntotal) < 0.5
    _agree(card.search(q[:16], 10, filter_mask=mask),
           cpu.search(q[:16], 10, filter_mask=mask))
