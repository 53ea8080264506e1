"""K4's plain version (ops/pq_decode.decode_reference) vs the JAX package.

On the CPU ``decode`` runs ``decode_reference``, the gather of JAX's
``ops/pq._decode_bf16``. It must be bit-exact (compared as raw bits) with
the TPU kernel run in interpret mode (``pallas_pq.decode(interpret=True)``),
with ``_decode_bf16`` itself, and at float32 with ``pq_decode``, including
shapes the TPU kernel refuses. The CUDA kernel is held to the same plain
version on the card (tests/test_torch_pq_card.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.ops import pallas_pq
from rag_faiss_embedding_tpu.ops import pq as jpq
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD


def _bits(x):
    """Raw bits of a bf16 / f32 array (numpy, jax or torch) as numpy ints."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.view(jnp.int16 if x.dtype == jnp.bfloat16 else jnp.int32))


def _case(m, ksub, dsub, n, seed=0):
    rng = np.random.default_rng(seed)
    cb = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    return cb, codes


def test_reference_matches_tpu_kernel_interpret_bit_exact():
    cb, codes = _case(16, 256, 8, 256)
    want = pallas_pq.decode(jnp.asarray(cb), jnp.asarray(codes), interpret=True)
    got = PD.decode_reference(torch.from_numpy(cb).to(torch.bfloat16),
                              torch.from_numpy(codes))
    assert got.dtype == torch.bfloat16 and got.shape == (256, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,ksub,dsub,n", [(16, 256, 8, 256), (12, 16, 8, 100),
                                           (48, 256, 8, 300), (5, 7, 3, 1)])
def test_reference_matches_decode_bf16_gather(m, ksub, dsub, n):
    cb, codes = _case(m, ksub, dsub, n, seed=m)
    want = jpq._decode_bf16(jnp.asarray(cb, jnp.bfloat16), jnp.asarray(codes))
    got = PD.decode(torch.from_numpy(cb).to(torch.bfloat16), torch.from_numpy(codes))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,ksub,dsub,n", [(12, 256, 8, 100), (16, 16, 4, 1000),
                                           (96, 256, 8, 64), (3, 2, 5, 7)])
def test_float32_decode_matches_pq_decode(m, ksub, dsub, n):
    """f32 codebooks (compute "f32") decode to f32 rows, bit for bit; M = 12
    and N = 100 are shapes the TPU kernel's gate refuses."""
    cb, codes = _case(m, ksub, dsub, n, seed=7 * m)
    want = np.asarray(jpq.pq_decode(jnp.asarray(cb), jnp.asarray(codes)))
    got = PD.decode(torch.from_numpy(cb), torch.from_numpy(codes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def test_cpu_decode_never_launches_and_takes_empty_input():
    cb, codes = _case(8, 16, 4, 0)
    before = PD.decode.launches
    out = PD.decode(torch.from_numpy(cb), torch.from_numpy(codes))
    assert out.shape == (0, 32)
    PD.decode(torch.from_numpy(_case(8, 16, 4, 9)[0]), torch.from_numpy(_case(8, 16, 4, 9)[1]))
    assert PD.decode.launches == before
    with pytest.raises(ValueError, match="do not match"):
        PD.decode(torch.from_numpy(cb), torch.zeros((3, 7), dtype=torch.uint8))


# The launch plan (ops/pq_decode.plan): a pure function of N, the codebook's
# shape and the card's limits, held here to the rules the kernel relies on.
# Path shapes (rows per launch, chip_smoke's PQ_PATH_ROWS): the PQ slice's
# 4,096 and 16,384, a shard's union (16,384, 32,768), union segments of the
# 10M chunked IVF-PQ (180,224, 360,448), flat PQ's 524,288-row chunks, 1M.
PATH_ROWS = (4096, 16384, 32768, 180224, 360448, 1 << 19, 1 << 20)
PLAN_SHAPES = [(48, 256, 8, torch.bfloat16), (48, 256, 8, torch.float32),
               (96, 256, 8, torch.bfloat16), (96, 256, 8, torch.float32),
               (48, 256, 16, torch.float32), (16, 256, 8, torch.bfloat16),
               (96, 16, 4, torch.bfloat16), (12, 256, 8, torch.float32),
               (5, 7, 3, torch.bfloat16), (5, 7, 3, torch.float32)]
PLAN_ROWS = (1, 2, 127, 1000, 4096, 16384, 65535, 65536, 100000, 1 << 20)


def _plans():
    for m, ksub, dsub, dtype in PLAN_SHAPES:
        for n in PLAN_ROWS + PATH_ROWS:
            yield m, ksub, dsub, dtype, n, PD.plan(m, ksub, dsub, dtype, n)


@pytest.mark.parametrize("m,ksub,dsub,dtype", PLAN_SHAPES)
def test_every_plan_fits_a_block(m, ksub, dsub, dtype):
    for n in PLAN_ROWS + PATH_ROWS:
        p = PD.plan(m, ksub, dsub, dtype, n)
        assert p["smem_bytes"] <= 232448
        assert 1 <= p["threads"] <= 1024 and p["threads"] % p["tw"] == 0
        assert p["groups"] * p["per_group"] >= m > (p["groups"] - 1) * p["per_group"]
        if p["staged"]:  # the group's codebook slice is in shared memory
            assert p["smem_bytes"] >= p["per_group"] * ksub * dsub * PD._ESIZE[dtype]
        else:
            assert p["smem_bytes"] == 0 and p["groups"] == 1
            assert p["grid_x"] * p["tile_rows"] >= n  # a tile per block


@pytest.mark.parametrize("m,ksub,dsub,dtype", PLAN_SHAPES)
def test_staging_moves_no_more_than_it_writes(m, ksub, dsub, dtype):
    for n in PLAN_ROWS + PATH_ROWS:
        p = PD.plan(m, ksub, dsub, dtype, n)
        assert p["out_bytes"] == n * m * dsub * PD._ESIZE[dtype]
        assert p["staged_bytes"] <= p["out_bytes"]
        assert p["staged_bytes"] == (p["grid_x"] * p["groups"] * p["smem_bytes"]
                                     if p["staged"] else 0)


@pytest.mark.parametrize("m,ksub,dsub,dtype", PLAN_SHAPES)
def test_grid_covers_the_sms_where_the_tiles_allow(m, ksub, dsub, dtype):
    for sms in (132, 114):
        for n in PLAN_ROWS + PATH_ROWS:
            p = PD.plan(m, ksub, dsub, dtype, n, sms=sms)
            blocks = p["grid_x"] * p["groups"]
            rows_down = p["threads"] // p["tw"]  # the fewest rows a tile takes
            if p["staged"]:  # walkers are held to the bytes written, else to the SMs
                walkers = min(-(-n // p["tile_rows"]),
                              p["out_bytes"] // (p["groups"] * p["smem_bytes"]))
                assert blocks >= min(sms - p["groups"] + 1, walkers * p["groups"])
            else:
                assert blocks >= min(sms, n // rows_down)


@pytest.mark.parametrize("m,ksub,dsub,dtype", PLAN_SHAPES)
def test_lanes_take_the_widest_chunks_and_slices_stay_aligned(m, ksub, dsub, dtype):
    """A row is tw chunks of 16 bytes where the subvector width allows (8, 4
    or 2 elsewhere), one lane each, so a warp stores a contiguous span; a
    staged slice starts each block's shared memory 16-byte aligned."""
    sub = dsub * PD._ESIZE[dtype]
    vb = next(v for v in (16, 8, 4, 2) if sub % v == 0)
    for n in PLAN_ROWS + PATH_ROWS:
        p = PD.plan(m, ksub, dsub, dtype, n)
        assert p["tw"] == min(p["per_group"] * sub // vb, 1024)
        assert p["smem_bytes"] % 16 == 0


@pytest.mark.parametrize("m,ksub,dsub,dtype", PLAN_SHAPES)
def test_crossovers_bound_one_band(m, ksub, dsub, dtype):
    """The plan stages on one band of N, from the first N at or above
    STAGED_MIN_ROWS whose staging the bytes written pay for, to the last N
    whose rows stay under STAGED_MAX_BYTES, and gathers through L2 on both
    sides."""
    band = PD.staged_rows(m, ksub, dsub, dtype)
    row_bytes = m * dsub * PD._ESIZE[dtype]
    ends = [] if band is None else [band.start, band.stop]
    grid = sorted({n for n in PLAN_ROWS + PATH_ROWS + tuple(
        e + d for e in ends for d in (-2, -1, 0, 1, 2)) if n >= 1})
    staged = [PD.plan(m, ksub, dsub, dtype, n)["staged"] for n in grid]
    switches = sum(a != b for a, b in zip(staged, staged[1:]))
    assert switches == (0 if band is None else 2)
    assert all(s == (band is not None and n in band) for n, s in zip(grid, staged))
    if band is not None:
        assert band.start >= PD.STAGED_MIN_ROWS
        assert (band.stop - 1) * row_bytes < PD.STAGED_MAX_BYTES <= band.stop * row_bytes


def test_plan_keeps_its_old_call_and_refuses_what_the_kernel_does_not_take():
    assert PD.plan(48, 256, 8, torch.bfloat16) == PD.plan(48, 256, 8, torch.bfloat16, 1 << 20)
    assert PD.plan(96, 256, 8, torch.float32, 8192)["groups"] > 1  # 768 KiB: staged in groups
    for bad in ((0, 256, 8), (48, 0, 8), (48, 257, 8), (48, 256, 0)):
        with pytest.raises(ValueError):
            PD.plan(*bad, torch.bfloat16)
    with pytest.raises(TypeError):
        PD.plan(48, 256, 8, torch.float16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_decode_writes_into_out(dtype):
    cb, codes = _case(6, 16, 4, 33, seed=3)
    cb_t, codes_t = torch.from_numpy(cb).to(dtype), torch.from_numpy(codes)
    buf = torch.full((33 * 24 + 1,), 7.0, dtype=dtype)
    view = buf[1:].view(33, 24)  # an output that starts off a 16-byte boundary
    got = PD.decode(cb_t, codes_t, out=view)
    assert got.data_ptr() == view.data_ptr() and buf[0] == 7.0
    np.testing.assert_array_equal(_bits(view), _bits(PD.decode_reference(cb_t, codes_t)))
    with pytest.raises(ValueError, match="out must be"):
        PD.decode(cb_t, codes_t, out=torch.empty((33, 23), dtype=dtype))
