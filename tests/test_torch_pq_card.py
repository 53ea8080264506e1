"""The PQ decode kernel and the port's PQ indexes on the card.

K4 (``csrc/pq_decode.cu``) must be bit-exact with ``decode_reference`` on
the same card tensors. A PQ or IVF-PQ index on the card must agree with the
same index (cross-loaded through its state) searched on the CPU through the
plain decode, and its kernel route (``backend="auto"``) must return the same
bits as its plain route (``backend="xla"``) on the card: both feed the same
decoded values to the same product.

Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so on the card they run with
``python -m pytest tests/test_torch_pq_card.py -m cuda --noconftest -q``.
Tolerance, card vs CPU: distances to rtol 1e-4 / atol 1e-4 x (max ||q||^2 +
max ||x̂||^2) (float32 sums in different orders); ids may differ only where
the distances agree.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex, PQIndex
from rag_faiss_embedding_tpu_torch.ops import pq as pq_ops
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD

RTOL = 1e-4
D = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _data(seed=0, n_modes=64, per=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, D)).astype(np.float32)
    pts = (centers[rng.integers(0, n_modes, n_modes * per)]
           + 0.4 * rng.standard_normal((n_modes * per, D))).astype(np.float32)
    q = (pts[::37] + 0.2 * rng.standard_normal((len(pts[::37]), D))).astype(np.float32)
    return pts, q


def _agree(card, cpu, q, rows):
    cv, ci = (t.cpu().numpy() for t in card)
    pv, pi = (t.cpu().numpy() for t in cpu)
    atol = RTOL * float((q.astype(np.float64) ** 2).sum(1).max()
                        + (rows.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(cv, pv, rtol=RTOL, atol=atol)
    diff = ci != pi
    assert np.allclose(cv[diff], pv[diff], rtol=RTOL, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,ksub,dsub", [(16, 256, 8), (48, 256, 8), (96, 16, 4),
                                         (12, 256, 8), (48, 256, 16), (5, 7, 3)])
@pytest.mark.parametrize("n", [0, 1, 127, 4096])
def test_decode_kernel_is_bit_exact(cuda, dtype, m, ksub, dsub, n):
    g = torch.Generator(device=cuda).manual_seed(m * 1000 + n)
    cb = torch.randn((m, ksub, dsub), generator=g, device=cuda).to(dtype)
    codes = torch.randint(0, ksub, (n, m), generator=g, device=cuda).to(torch.uint8)
    before = PD.decode.launches
    out = PD.decode(cb, codes)
    torch.cuda.synchronize()
    assert PD.decode.launches == before + (n > 0)
    assert out.dtype == dtype and out.shape == (n, m * dsub)
    assert torch.equal(out, PD.decode_reference(cb, codes))


@pytest.mark.cuda
def test_decode_kernel_takes_unaligned_codes_and_wide_codebooks(cuda):
    """Codes at an odd byte offset are read byte by byte on both gather
    paths; a codebook too large for shared memory in one piece is staged in
    subspace groups (8,192 rows) or read through L2 (1,000 rows)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    cb = torch.randn((96, 256, 8), generator=g, device=cuda)          # 768 KiB f32
    codes = torch.randint(0, 256, (8193, 96), generator=g, device=cuda).to(torch.uint8)
    for n, staged in ((1000, 0), (8192, 1)):
        odd = codes.view(-1)[1:1 + n * 96].view(n, 96)
        assert odd.data_ptr() % 16
        p = PD.plan(96, 256, 8, torch.float32, n)
        assert p["staged"] == staged and (p["groups"] > 1) == bool(staged)
        assert torch.equal(PD.decode(cb, odd), PD.decode_reference(cb, odd))
    with pytest.raises(ValueError):
        PD.decode(cb[:, :0], codes)


def _decode_case(cuda, m, ksub, dsub, dtype, n, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    cb = torch.randn((m, ksub, dsub), generator=g, device=cuda).to(dtype)
    codes = torch.randint(0, ksub, (n, m), generator=g, device=cuda).to(torch.uint8)
    return cb, codes


def _same_bits(a, b):
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))


# the plan's switch points and tile edges, at the paths' codebooks (M 48,
# D 384, bf16 and f32), f32 with 16- and 32-value subvectors, and D 768
DECODE_SHAPES = [(48, 256, 8, torch.bfloat16), (48, 256, 8, torch.float32),
                 (24, 256, 16, torch.float32), (96, 256, 8, torch.bfloat16),
                 (96, 256, 8, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,ksub,dsub,dtype", DECODE_SHAPES)
def test_decode_kernel_is_bit_exact_on_both_sides_of_the_crossovers(cuda, m, ksub, dsub, dtype):
    sms, smem_limit = PD._card(cuda.index or 0)
    band = PD.staged_rows(m, ksub, dsub, dtype, sms=sms, smem_limit=smem_limit)
    assert band is not None
    for n in (band.start - 1, band.start, band.stop - 1, band.stop):
        assert PD.plan(m, ksub, dsub, dtype, n, sms=sms, smem_limit=smem_limit)["staged"] == (
            n in band)
        cb, codes = _decode_case(cuda, m, ksub, dsub, dtype, n, seed=n)
        before = PD.decode.launches
        out = PD.decode(cb, codes)
        torch.cuda.synchronize()
        assert PD.decode.launches == before + 1
        assert _same_bits(out, PD.decode_reference(cb, codes))


@pytest.mark.cuda
@pytest.mark.parametrize("m,ksub,dsub,dtype", DECODE_SHAPES)
@pytest.mark.parametrize("path_n", [4096, 16384, 360448])
def test_decode_kernel_is_bit_exact_at_a_tile_and_its_edges(cuda, m, ksub, dsub, dtype, path_n):
    """N 1, 127, a path's row count, and whole tiles of the plan there, one
    row short and one past (a ragged last tile)."""
    tile = PD.plan(m, ksub, dsub, dtype, path_n)["tile_rows"]
    whole = max(1, path_n // tile) * tile
    for n in (1, 127, tile, whole - 1, whole, whole + 1, path_n):
        cb, codes = _decode_case(cuda, m, ksub, dsub, dtype, n, seed=n)
        before = PD.decode.launches
        out = PD.decode(cb, codes)
        torch.cuda.synchronize()
        assert PD.decode.launches == before + 1
        assert _same_bits(out, PD.decode_reference(cb, codes)), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [100, 16384, 200000])
def test_decode_kernel_writes_an_unaligned_output_view(cuda, dtype, n):
    """An output that starts off a 16-byte boundary cannot take the bulk
    copy: the threads store it, in the same kernel, and touch nothing
    around it."""
    m, ksub, dsub = 48, 256, 8
    cb, codes = _decode_case(cuda, m, ksub, dsub, dtype, n, seed=5)
    buf = torch.full((n * m * dsub + 2,), 3.0, dtype=dtype, device=cuda)
    view = buf[1:1 + n * m * dsub].view(n, m * dsub)
    assert view.data_ptr() % 16
    got = PD.decode(cb, codes, out=view)
    torch.cuda.synchronize()
    assert got.data_ptr() == view.data_ptr()
    assert _same_bits(view, PD.decode_reference(cb, codes))
    assert buf[0] == 3.0 and buf[-1] == 3.0


@pytest.mark.cuda
def test_train_pq_repeats_on_card(cuda):
    pts, _ = _data()
    x = torch.from_numpy(pts).to(cuda)
    a = pq_ops.train_pq(x, 16, n_iters=6, seed=0)
    b = pq_ops.train_pq(x, 16, n_iters=6, seed=0)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("opq", [False, True])
def test_pq_index_card_routes_match_cpu_plain(cuda, compute, opq):
    pts, q = _data(seed=1)
    cpu = PQIndex(D, m=16, compute_dtype=compute, opq=opq, train_iters=6, device="cpu",
                  backend="xla")
    cpu.build(pts)
    card = PQIndex.from_state_dict(cpu.state_dict(), device=cuda)
    xla = PQIndex.from_state_dict(cpu.state_dict(), device=cuda, backend="xla")
    before = PD.decode.launches
    out = card.search(q, 10)
    torch.cuda.synchronize()
    assert PD.decode.launches > before
    launched = PD.decode.launches
    plain = xla.search(q, 10)
    assert PD.decode.launches == launched  # backend="xla" never launches
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    _agree(out, cpu.search(q, 10), q, cpu.vectors())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(pq_compute="bf16"),
                                dict(pq_compute="f32", pq_opq=True),
                                dict(pq_compute="f32", rerank=True),
                                dict(pq_compute="bf16", rerank=True, refine_dtype="bfloat16")])
def test_ivfpq_card_routes_match_cpu_plain(cuda, kw):
    pts, q = _data(seed=2)
    cpu = IVFFlatIndex(D, nlist=32, nprobe=8, pq_m=16, train_iters=6, device="cpu",
                       backend="xla", **kw)
    cpu.build(pts)
    card = IVFFlatIndex.from_state_dict(cpu.state_dict(), device=cuda)
    xla = IVFFlatIndex.from_state_dict(cpu.state_dict(), device=cuda, backend="xla")
    for nq in (1, len(q)):
        before = PD.decode.launches
        out = card.search(q[:nq], 10)
        torch.cuda.synchronize()
        assert PD.decode.launches > before
        plain = xla.search(q[:nq], 10)
        assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
        _agree(out, cpu.search(q[:nq], 10), q[:nq], pts)
    # removed rows stay out of the card route, refine or not
    _, first = card.search(q[:8], 1)
    kill = torch.unique(first[:, 0]).cpu().numpy()
    card.remove_ids(kill)
    _, ids = card.search(q[:8], 10)
    assert not np.isin(ids.cpu().numpy(), kill).any()
