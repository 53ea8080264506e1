"""The sharded indexes on the card: four shards on one card, and one shard
on each card where there are several, each shard launching its kernel on
its own card, held to the one-card index and to the plain routes.

Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so on the card they run with
``python -m pytest tests/test_torch_sharded_card.py -m cuda --noconftest -q``.
Tolerance: distances to rtol 1e-4 / atol 1e-3 (float32 sums in different
orders; D = 128, unit-normal data); ids may differ only where the distances
agree.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.index import FlatIndex
from rag_faiss_embedding_tpu_torch.ops import flat_scan as F
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD
from rag_faiss_embedding_tpu_torch.ops import union_scan as U
from rag_faiss_embedding_tpu_torch.parallel import ShardedFlatIndex
from rag_faiss_embedding_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

RTOL, ATOL = 1e-4, 1e-3
D = 128


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return make_mesh({"db": 4}, devices=[torch.device("cuda", 0)] * 4)


def _data(seed=0, n_modes=64, per=96):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, D)).astype(np.float32)
    pts = (centers[rng.integers(0, n_modes, n_modes * per)]
           + 0.4 * rng.standard_normal((n_modes * per, D))).astype(np.float32)
    q = (pts[::37] + 0.2 * rng.standard_normal((len(pts[::37]), D))).astype(np.float32)
    return pts, q


def _agree(a, b):
    av, ai = (t.cpu().numpy() for t in a)
    bv, bi = (t.cpu().numpy() for t in b)
    np.testing.assert_allclose(av, bv, rtol=RTOL, atol=ATOL)
    diff = ai != bi
    assert np.allclose(av[diff], bv[diff], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_flat_equals_one_card_flat_one_k1_per_shard(mesh, dtype):
    pts, q = _data(per=128)  # 8,192 rows: every shard holds 2,048
    cuda = torch.device("cuda")
    sharded = ShardedFlatIndex(D, mesh, dtype=dtype, capacity=len(pts))
    assert sharded._capacity == len(pts)
    one = FlatIndex(D, dtype=dtype, device=cuda)
    sharded.add(pts)
    one.add(pts)
    sharded.remove_ids(np.arange(0, len(pts), 7))
    one.remove_ids(np.arange(0, len(pts), 7))
    for k in (1, 10, 100):
        before = F.flat_search.launches
        got = sharded.search(q, k)
        assert F.flat_search.launches - before == 4
        _agree(got, one.search(q, k))
    # a shard with no row past the watermark launches nothing
    few = ShardedFlatIndex(D, mesh, dtype=dtype, capacity=len(pts))
    few.add(pts[:3000])
    want = FlatIndex.from_state_dict(few.state_dict(), device=cuda).search(q, 10)
    before = F.flat_search.launches
    _agree(few.search(q, 10), want)
    assert F.flat_search.launches - before == 2
    keep = np.arange(len(pts)) % 3 > 0
    _agree(sharded.search(q, 10, filter_mask=keep), one.search(q, 10, filter_mask=keep))


@pytest.mark.cuda
def test_sharded_ivf_launches_k2_per_shard_and_equals_plain(mesh):
    pts, q = _data()
    idx = ShardedIVFIndex(D, mesh, nlist=64, nprobe=8, dtype="bfloat16", train_iters=8)
    idx.build(pts)
    before = U.union_scan.launches
    got = idx.search(q, 10)
    assert U.union_scan.launches - before == 4
    idx.backend = "xla"
    plain = idx.search(q, 10)
    assert U.union_scan.launches - before == 4
    _agree(got, plain)


@pytest.mark.cuda
def test_sharded_ivf_pq_launches_k4_per_shard_and_equals_plain(mesh):
    pts, q = _data()
    idx = ShardedIVFIndex(D, mesh, nlist=64, nprobe=8, train_iters=8, pq_m=16)
    idx.build(pts)
    before = PD.decode.launches
    got = idx.search(q, 10)
    assert PD.decode.launches - before >= 4
    idx.backend = "xla"
    plain = idx.search(q, 10)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[0], plain[0])


@pytest.mark.cuda
def test_card_index_equals_its_cpu_copy(mesh):
    """The same state on four card shards and on four CPU shards: the card's
    kernels against their plain versions, end to end."""
    pts, q = _data(seed=1)
    idx = ShardedIVFIndex(D, mesh, nlist=64, nprobe=8, train_iters=8)
    idx.build(pts)
    idx.add(pts[:40] + 0.01)
    cpu = ShardedIVFIndex.from_state_dict(
        idx.state_dict(), mesh=make_mesh({"db": 4}, devices=[torch.device("cpu")] * 4))
    _agree(idx.search(q, 10), cpu.search(q, 10))


@pytest.mark.cuda
def test_shards_on_several_cards_launch_on_their_own_card():
    """One shard on each visible card (two or more): every kernel launches
    on the card that holds its shard, and the answers equal the same index
    with all its shards on the first card; a "data" axis searches each
    data row's own copy of the shards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs (one shard on each)")
    from rag_faiss_embedding_tpu_torch.parallel import sharded_exact_search

    mesh = make_mesh()  # every visible card on a "db" axis
    n = mesh.size
    first = torch.device("cuda", 0)
    on_first = make_mesh({"db": n}, devices=[first] * n)
    pts, q = _data(per=128)
    flat = ShardedFlatIndex(D, mesh, capacity=len(pts))
    flat.add(pts)
    assert [t.device for t in flat._buf] == mesh.axis_devices("db")
    one = FlatIndex(D, device=first)
    one.add(pts)
    before = F.flat_search.launches
    got = flat.search(q, 10)
    assert F.flat_search.launches - before == n and got[0].device == first
    _agree(got, one.search(q, 10))
    for kw in ({"dtype": "bfloat16"}, {"pq_m": 16}):
        idx = ShardedIVFIndex(D, mesh, nlist=64, nprobe=8, train_iters=8, **kw)
        idx.build(pts)
        assert [t.device for t in idx._vecs] == mesh.axis_devices("db")
        same = ShardedIVFIndex.from_state_dict(idx.state_dict(), mesh=on_first)
        k2, k4 = U.union_scan.launches, PD.decode.launches
        got = idx.search(q, 10)
        if "pq_m" in kw:
            assert PD.decode.launches - k4 >= n
        else:
            assert U.union_scan.launches - k2 == n
        _agree(got, same.search(q, 10))
    if n % 2 == 0:
        grid = make_mesh({"data": 2, "db": -1})
        qe = q[: len(q) // 2 * 2]
        before = F.flat_search.launches
        got = sharded_exact_search(grid, qe, pts, 10, data_axis="data")
        assert F.flat_search.launches - before == n and got[0].device == first
        _agree(got, one.search(qe, 10))


@pytest.mark.cuda
def test_every_card_s_scan_starts_while_the_first_card_s_runs():
    """One search over a shard on each visible card (two or more), 2,097,152
    rows of 384 a shard so each scan runs over a millisecond: every other
    card's first stage-1 K1 starts before the first card's K1 ends. A query
    copied after the first launch would wait behind that launch's scan."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs (one shard on each)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_faiss_embedding_tpu_torch.parallel import sharded_exact_search

    mesh = make_mesh()
    cards = mesh.axis_devices("db")
    gen = [torch.Generator(device=c).manual_seed(j) for j, c in enumerate(cards)]
    shards = [torch.randn((2_097_152, 384), device=c, generator=g) for c, g in zip(cards, gen)]
    sq = [(s * s).sum(1) for s in shards]
    q = torch.randn((1, 384), device=cards[0], generator=gen[0])

    def search():
        out = sharded_exact_search(mesh, q, shards, 10, db_sq=sq)
        for c in cards:
            torch.cuda.synchronize(c)
        return out

    for _ in range(3):  # the build, the launch shapes, the allocator
        search()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        search()
    first = {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.device_type() == DeviceType.CUDA and any(
                n in e.name() for n in ("scan_partial", "scan_tiled")):
            first.setdefault(e.device_index(), (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(first) == [c.index for c in cards]
    end0 = first[cards[0].index][1]
    assert end0 - first[cards[0].index][0] > 500_000  # the scan runs over 0.5 ms
    late = {c: first[c][0] - first[cards[0].index][0] for c in first}
    assert all(first[c.index][0] < end0 for c in cards[1:]), late
    print("K1 start after the first card's, ns:", late)
