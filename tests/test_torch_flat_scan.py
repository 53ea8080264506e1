"""Flat-scan kernel port (ops/flat_scan.py) vs the JAX Pallas flat scan.

The CPU tests mirror tests/test_pallas_scan.py: the same seeded numpy inputs
go through the JAX ``pallas_scan.flat_search`` (interpret mode, as its own
tests run it) and the port's ``flat_search_reference``, the plain torch
version of the CUDA kernel. Tolerances: f32 distances rtol 1e-5 / atol 1e-4,
bf16 rtol 1e-2 (the JAX kernel takes bf16 products at default precision);
ids identical (the inputs have no near-ties).

The ``cuda`` tests compare the kernel with its plain version on the card and
skip without one. They import no JAX, so they run on a machine without it:
``python -m pytest tests/test_torch_flat_scan.py -m cuda --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.ops import flat_scan as F

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def jax_ref():
    """The JAX package's (distance, pallas_scan) modules."""
    pytest.importorskip("jax")
    from rag_faiss_embedding_tpu.ops import distance, pallas_scan

    return distance, pallas_scan


def _port(q, db, k, **kw):
    v, i = F.flat_search(torch.from_numpy(q), torch.from_numpy(db), k, **kw)
    return v.numpy(), i.numpy()


def _pallas(jax_ref, q, db, k, tile_n=128, **kw):
    v, i = jax_ref[1].flat_search(q, db, k, tile_q=8, tile_n=tile_n,
                                  interpret=True, **kw)
    return np.asarray(v), np.asarray(i)


def _assert_same(port, ref, rtol=RTOL):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("nq,n,d", [(8, 512, 32), (16, 1000, 16)])
def test_matches_pallas(rng, jax_ref, metric, nq, n, d):
    q = rng.standard_normal((nq, d)).astype(np.float32)
    db = rng.standard_normal((n, d)).astype(np.float32)
    _assert_same(_port(q, db, 7, metric=metric),
                 _pallas(jax_ref, q, db, 7, tile_n=256, metric=metric))


def test_masks_invalid_rows(rng, jax_ref):
    db = rng.standard_normal((300, 16)).astype(np.float32)
    db_padded = np.concatenate([db, 1e6 * np.ones((100, 16), np.float32)])
    q = rng.standard_normal((4, 16)).astype(np.float32)
    port = _port(q, db_padded, 5, n_valid=300)
    assert (port[1] < 300).all()
    _assert_same(port, _pallas(jax_ref, q, db_padded, 5, n_valid=300))


def test_tie_break_lowest_index(rng, jax_ref):
    row = rng.standard_normal(16).astype(np.float32)
    db = np.stack([row] * 6)  # all identical: ties everywhere
    port = _port(row[None], db, 4)
    np.testing.assert_array_equal(port[1][0], [0, 1, 2, 3])
    _assert_same(port, _pallas(jax_ref, row[None], db, 4))


def test_k_larger_than_n(rng, jax_ref):
    db = rng.standard_normal((5, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    port = _port(q, db, 9)
    assert port[1].shape == (2, 9)
    assert (port[1][:, 5:] == -1).all()
    _assert_same(port, _pallas(jax_ref, q, db, 9))


def test_agrees_with_pallas_bf16(rng, jax_ref):
    import jax.numpy as jnp

    q = rng.standard_normal((8, 32)).astype(np.float32)
    db = rng.standard_normal((400, 32)).astype(np.float32)
    q16, db16 = jnp.asarray(q, jnp.bfloat16), jnp.asarray(db, jnp.bfloat16)
    sq = jax_ref[0].sqnorms(db16)
    ref = _pallas(jax_ref, q16, db16, 5, db_sq=sq)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tdb = torch.from_numpy(db).to(torch.bfloat16)
    v, i = F.flat_search(tq, tdb, 5, db_sq=torch.from_numpy(np.array(sq)))
    _assert_same((v.numpy(), i.numpy()), ref, rtol=1e-2)


def test_masks_invalid(rng, jax_ref):
    db = rng.standard_normal((700, 16)).astype(np.float32)
    dbp = np.concatenate([db, 1e6 * np.ones((324, 16), np.float32)])
    q = rng.standard_normal((4, 16)).astype(np.float32)
    port = _port(q, dbp, 5, n_valid=700)
    assert (port[1] < 700).all()
    _assert_same(port, _pallas(jax_ref, q, dbp, 5, tile_n=256, n_valid=700))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_k_larger_than_n_valid_in_padded_buffer(rng, jax_ref, metric):
    """k > n_valid inside a padded buffer: missing slots hold -1 and inf
    (-inf for IP), as the JAX exact_search returns. The JAX Pallas kernel
    instead re-selects masked rows there and reports live row ids again
    (ids >= 0 with distance ~3.4e38); the port follows the documented
    contract, for the kernel and its plain version alike."""
    db = rng.standard_normal((1024, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    port = _port(q, db, 5, metric=metric, n_valid=3)
    jv, ji = jax_ref[0].exact_search(q, db, 5, metric=metric, n_valid=3)
    _assert_same(port, (np.asarray(jv), np.asarray(ji)))
    assert (port[1][:, 3:] == -1).all()
    fill = np.inf if metric == "L2" else -np.inf
    assert (port[0][:, 3:] == fill).all()
    # the reference kernel's divergence, as it stands
    _, pi = _pallas(jax_ref, q, db, 5, tile_n=1024, metric=metric, n_valid=3)
    assert (pi[:, 3:] >= 0).all()


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_kernel_vs_plain(q, db, k, metric, n_valid=None, path=None):
    launches = F.flat_search.launches
    kv, ki = F.flat_search(q, db, k, metric=metric, n_valid=n_valid, path=path)
    torch.cuda.synchronize()
    assert F.flat_search.launches == launches + 1
    pv, pi = F.flat_search_reference(q, db, k, metric=metric, n_valid=n_valid)
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    assert kv.shape == pv.shape and ki.shape == pi.shape
    rtol = RTOL if db.dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(kv, pv, rtol=rtol, atol=ATOL)
    # ids may differ only at near-ties, where the values agree
    diff = ki != pi
    assert np.allclose(kv[diff], pv[diff], rtol=rtol, atol=ATOL)
    return ki


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("nq,n,d,k", [
    (1, 1000, 16, 5), (7, 3000, 384, 10), (40, 5000, 20, 64), (300, 2048, 64, 1),
])
def test_kernel_matches_plain_on_card(rng, cuda, dtype, metric, nq, n, d, k):
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    _check_kernel_vs_plain(q.to(cuda, dtype), db.to(cuda, dtype), k, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "tiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("nq,n,d,k", [
    (1, 3001, 16, 1), (7, 3001, 100, 10), (65, 5000, 384, 64), (1000, 2900, 384, 10),
    (65, 3001, 1030, 10), (7, 3001, 2048, 10),
])
def test_every_path_matches_plain_on_card(rng, cuda, path, dtype, metric, nq, n, d, k):
    """Each stage-1 path, forced, at Q off the query tiles (1, 7, 65, 1,000)
    and N off the row tiles, k 1 / 10 / 64, D from 16 to 2,048 (100 and
    1,030 take the scalar staging, 1,030 and 2,048 the column chunks of the
    whole-row path)."""
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    _check_kernel_vs_plain(q.to(cuda, dtype), db.to(cuda, dtype), k, metric, path=path)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,d", [(1, 1030), (37, 2048)])
def test_kernel_wide_rows_on_card(rng, cuda, dtype, nq, d):
    """Rows wider than a shared-memory tile are staged in column chunks."""
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((3000, d)).astype(np.float32))
    _check_kernel_vs_plain(q.to(cuda, dtype), db.to(cuda, dtype), 10, "L2")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_kernel_edges_on_card(rng, cuda, metric):
    db = torch.from_numpy(rng.standard_normal((1500, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    ki = _check_kernel_vs_plain(q.to(cuda), db.to(cuda), 8, metric, n_valid=5)
    assert (ki[:, 5:] == -1).all()
    row = db[:1].to(cuda)
    ki = _check_kernel_vs_plain(row, row.repeat(700, 1), 10, metric)
    np.testing.assert_array_equal(ki[0], np.arange(10))
    with pytest.raises(ValueError, match="KMAX"):
        F.flat_search(q.to(cuda), db.to(cuda), F.KMAX + 1, metric=metric)
    with pytest.raises(TypeError):
        F.flat_search(q.to(cuda), db.to(cuda, torch.bfloat16), 4, metric=metric)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "tiled"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_every_path_edges_on_card(rng, cuda, path, metric):
    """n_valid < N, k > n_valid, k > N (the output padded to k), and 5,000
    identical rows (ties to ids 0..9), on each path."""
    db = torch.from_numpy(rng.standard_normal((4000, 384)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((70, 384)).astype(np.float32)).to(cuda)
    ki = _check_kernel_vs_plain(q, db, 10, metric, n_valid=2500, path=path)
    assert (ki < 2500).all()
    ki = _check_kernel_vs_plain(q, db, 10, metric, n_valid=3, path=path)
    assert (ki[:, 3:] == -1).all() and (ki[:, :3] >= 0).all()
    kv, ki = F.flat_search(q, db[:5], 9, metric=metric, path=path)
    fill = np.inf if metric == "L2" else -np.inf
    assert ki.shape == (70, 9) and (ki[:, 5:] == -1).all().item()
    assert (kv[:, 5:].cpu().numpy() == fill).all()
    row = db[:1]
    for nq in (1, 70):
        ki = _check_kernel_vs_plain(row.repeat(nq, 1), row.repeat(5000, 1), 10, metric,
                                    path=path)
        assert (ki == np.arange(10)).all()


@pytest.mark.cuda
def test_no_device_work_after_the_two_launches(rng, cuda):
    """On a CUDA tensor a search is the two kernels and nothing else: the
    epilogue (distances, -1 / inf fill) is in stage 2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    db = torch.from_numpy(rng.standard_normal((5000, 384)).astype(np.float32)).to(cuda)
    db_sq = (db * db).sum(1)
    for nq in (1, 100):
        q = torch.from_numpy(rng.standard_normal((nq, 384)).astype(np.float32)).to(cuda)
        F.flat_search(q, db, 10, db_sq=db_sq)  # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            F.flat_search(q, db, 10, db_sq=db_sq, n_valid=4000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 2, names
        assert any("scan" in n for n in names) and any("merge_partials" in n for n in names)


def test_check_k_rejects_above_kmax():
    F.check_k(F.KMAX)
    with pytest.raises(ValueError, match="KMAX"):
        F.check_k(F.KMAX + 1)


@pytest.mark.parametrize("d", [1, 16, 384, 768, 1000, 1030, 4096])
def test_chunk_widths(d):
    """The whole padded row first, then narrower chunks that keep every
    chunk start on a 16-byte boundary for both dtypes."""
    widths = F.chunk_widths(d)
    d4 = -(-d // 4) * 4
    assert widths[0] == d4
    assert list(widths) == sorted(widths, reverse=True)
    assert all(w % 8 == 0 and w < d4 for w in widths[1:])


@pytest.mark.parametrize("nq", [1, 7, 8, 9, 16, 24, 25, 32, 63, 64, 65, 256, 1024])
def test_choose_path_by_q(nq):
    """One query per warp below TILED_MIN_Q, the tiled block from there;
    the single request (Q = 1) never pays for a tile of 128 queries."""
    assert F.choose_path(nq) == (F.TILED if nq >= F.TILED_MIN_Q else F.WARP)
    assert 1 < F.TILED_MIN_Q <= 1024
    assert F.choose_path(1) == F.WARP and F.choose_path(1024) == F.TILED


@pytest.mark.parametrize("nq,n_rows,capacity", [
    (64, 1 << 20, 264), (1024, 1 << 20, 264), (1024, 1 << 20, 132), (1000, 2900, 264),
    (65, 12345, 264), (4096, 1 << 20, 264), (128, 100, 264),
])
def test_tiled_plan_covers_rows_in_whole_tiles(nq, n_rows, capacity):
    """The tiled path's split plan (128-query x 128-row tiles, one wave):
    every row in exactly one split of whole tiles, no split empty, and the
    wave target met wherever there are tiles enough."""
    rows, splits = F.plan_splits(nq, n_rows, 128, 128, capacity, F._TILED_WAVES)
    assert rows % 128 == 0 and rows > 0
    assert (splits - 1) * rows < n_rows <= splits * rows
    q_blocks = -(-nq // 128)
    want = max(1, -(-F._TILED_WAVES * capacity // q_blocks))
    n_tiles = -(-n_rows // 128)
    if n_tiles <= want:
        assert splits == n_tiles
    else:
        assert want // 2 <= splits <= want


@pytest.mark.parametrize("nq,n_rows,capacity", [
    (1, 4096, 264), (1, 1 << 20, 264), (16, 1 << 20, 264), (1024, 1 << 20, 132),
    (7, 100, 264), (300, 65536, 132),
])
def test_plan_splits_covers_rows_in_whole_tiles(nq, n_rows, capacity):
    """The stage-1 split plan: whole tiles, every row covered, no empty
    split, and the wave target met wherever there are tiles enough."""
    block_q = 8
    rows, splits = F.plan_splits(nq, n_rows, block_q, 64, capacity)
    assert rows % 64 == 0
    assert (splits - 1) * rows < n_rows <= splits * rows
    want = -(-8 * capacity // -(-nq // block_q))  # eight waves of blocks
    n_tiles = -(-n_rows // 64)
    if n_tiles <= want:
        assert splits == n_tiles
    else:
        assert want // 2 <= splits <= want
