"""IVF union-scan port (ops/union_scan.py) vs the JAX Pallas union scan.

The CPU tests feed the same seeded numpy inputs to the JAX
``pallas_ivf.union_scan`` (interpret mode, as its own tests run it) and the
port's ``union_scan_reference``, the plain torch version of the CUDA kernel,
for both variants, ``ktop``, L2 / IP and float32 / bfloat16 storage. Both
packed outputs are decoded (``decode_topk`` / ``decode_selected``) and
compared: ids identical; values to rtol 1e-5 / atol 1e-4. The packing
truncates ceil(log2 U) = 3 low mantissa bits (2^-20 relative), and the two
sides sum the same float32 products in different orders. The decoders
themselves are held bit for bit on the JAX kernel's own output.

The ``cuda`` tests compare the kernel with its plain version on the card and
skip without one. They import no JAX:
``python -m pytest tests/test_torch_union_scan.py -m cuda --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.ops import union_scan as U

RTOL, ATOL = 1e-5, 1e-4
D, WINDOW, NLIST = 128, 128, 12


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def pallas_ivf():
    pytest.importorskip("jax")
    from rag_faiss_embedding_tpu.ops import pallas_ivf

    return pallas_ivf


def _inputs(rng, chunks=2, qc=16, u=8, nlist=NLIST, window=WINDOW, d=D,
            dead_frac=0.2, dtype="float32"):
    """Block-padded storage with a dead sentinel block, some dead slots, and
    per-chunk sorted unions that include the sentinel id."""
    codes = rng.standard_normal(((nlist + 1) * window, d)).astype(np.float32)
    ids = rng.permutation((nlist + 1) * window).astype(np.int32)
    ids[rng.random(ids.shape) < dead_frac] = -1
    ids[nlist * window:] = -1
    codes[nlist * window:] = 0.0
    u_all = np.stack([
        np.sort(np.concatenate([rng.choice(nlist, u - 1, replace=False), [nlist]]))
        for _ in range(chunks)]).astype(np.int32)
    qs = rng.standard_normal((chunks, qc, d)).astype(np.float32)
    if dtype == "bfloat16":  # round through bf16 once, for both sides
        codes = torch.from_numpy(codes).bfloat16().float().numpy()
        qs = torch.from_numpy(qs).bfloat16().float().numpy()
    sq = (codes * codes).sum(1).astype(np.float32)
    return qs, u_all, codes, sq, ids


def _jax(pallas_ivf, inp, dtype, **kw):
    import jax.numpy as jnp

    qs, u_all, codes, sq, ids = inp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    window = kw["window"]
    bb = pallas_ivf.pick_bb(window, qs.shape[2], jnp.dtype(jdt).itemsize, u_all.shape[1])
    return pallas_ivf.union_scan(
        jnp.asarray(qs, jdt), jnp.asarray(u_all),
        jnp.asarray(codes, jdt).reshape(-1, window, qs.shape[2]),
        jnp.asarray(sq), jnp.asarray(ids), bb=bb, interpret=True, **kw)


def _torch(inp, dtype, fn=U.union_scan_reference, device="cpu", **kw):
    qs, u_all, codes, sq, ids = inp
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    window = kw["window"]
    return fn(t(qs).to(tdt), t(u_all), t(codes).to(tdt).view(-1, window, qs.shape[2]),
              t(sq), t(ids), **kw)


def _decode_port(out, inp, k, window):
    _, u_all, _, _, ids = inp
    u_t, ids_t = torch.from_numpy(u_all), torch.from_numpy(ids)
    if isinstance(out, tuple):
        v, i = U.decode_selected(out[0].cpu(), out[1].cpu(), u_t, ids_t, window=window, k=k)
    else:
        v, i = U.decode_topk(out.cpu(), u_t, ids_t, window=window, k=k)
    return v.numpy(), i.numpy()


def _decode_jax(pallas_ivf, out, inp, k, window):
    import jax.numpy as jnp

    _, u_all, _, _, ids = inp
    if isinstance(out, (tuple, list)):
        v, i = pallas_ivf.decode_selected(out[0], out[1], jnp.asarray(u_all),
                                          jnp.asarray(ids), window=window, k=k)
    else:
        v, i = pallas_ivf.decode_topk(out, jnp.asarray(u_all), jnp.asarray(ids),
                                      window=window, k=k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("variant,ktop", [(1, 0), (2, 0), (2, 10)])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas(rng, pallas_ivf, variant, ktop, metric, dtype):
    inp = _inputs(rng, dtype=dtype)
    kw = dict(window=WINDOW, cap=2, metric=metric, variant=variant, ktop=ktop)
    jout = _jax(pallas_ivf, inp, dtype, **kw)
    tout = _torch(inp, dtype, **kw)
    if ktop:
        assert tout[0].shape == tout[1].shape == (2, 16, U.KPAD)
    else:
        assert tout.shape == (2, 16, 2 * WINDOW)
    jv, ji = _decode_jax(pallas_ivf, jout, inp, 10, WINDOW)
    tv, ti = _decode_port(tout, inp, 10, WINDOW)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert (ti >= 0).all()  # eight blocks hold plenty of live rows
    # the decoders agree bit for bit on the same packed input
    if ktop:
        pv, pi = _decode_port((torch.from_numpy(np.array(jout[0])),
                               torch.from_numpy(np.array(jout[1]))), inp, 10, WINDOW)
    else:
        pv, pi = _decode_port(torch.from_numpy(np.array(jout)), inp, 10, WINDOW)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)


def test_variant2_dead_rows_and_k_beyond_candidates(rng, pallas_ivf):
    """A union of mostly dead blocks: variant 2 never surfaces a dead row,
    and k past the live candidates decodes to -1 / NEG_INF on both sides."""
    inp = _inputs(rng, chunks=1, u=2, dead_frac=0.97)
    kw = dict(window=WINDOW, cap=2, metric="L2", variant=2, ktop=0)
    tv, ti = _decode_port(_torch(inp, "float32", **kw), inp, 40, WINDOW)
    jv, ji = _decode_jax(pallas_ivf, _jax(pallas_ivf, inp, "float32", **kw), inp, 40, WINDOW)
    np.testing.assert_array_equal(ti, ji)
    live = set(inp[4][inp[4] >= 0].tolist())
    assert set(ti[ti >= 0].tolist()) <= live
    assert (ti == -1).any() and (tv[ti == -1] == U.NEG_INF).all()


def test_monotone_map_bit_exact(pallas_ivf):
    """The order map and its inverse, bit for bit against the JAX ones, on
    edge floats: -0.0, denormals, NEG_INF, the largest finite values."""
    import jax.numpy as jnp

    vals = np.array([-3.4028235e38, -1e6, -1.5, -1e-30, -1e-45, -0.0, 0.0,
                     1e-45, 1e-30, 2.5, 1e36, 3.4028235e38], np.float32)
    mono = U.mono_i32(torch.from_numpy(vals))
    host = np.array([pallas_ivf._mono_i32_host(float(v)) for v in vals])
    np.testing.assert_array_equal(mono.numpy(), host)
    assert (np.diff(host) > 0).all()
    assert [U.mono_i32_host(float(v)) for v in vals] == host.tolist()
    back = U.unmonotone_f32(mono).numpy()
    np.testing.assert_array_equal(back.view(np.int32), vals.view(np.int32))
    jback = np.asarray(pallas_ivf._unmonotone_f32(jnp.asarray(host, jnp.int32)))
    np.testing.assert_array_equal(back.view(np.int32), jback.view(np.int32))
    nbits = 8
    assert U.init_packed(nbits) == pallas_ivf._mono_i32_host(-3.4028235e38) & ~255


@pytest.mark.parametrize("window,dim,itemsize,u", [
    (128, 384, 2, 256), (1024, 384, 4, 256), (128, 384, 2, 8), (256, 384, 2, 128),
    (128, 128, 4, 3), (2048, 768, 4, 64),
])
def test_pick_bb_equals_jax(pallas_ivf, window, dim, itemsize, u):
    assert U.pick_bb(window, dim, itemsize, u) == pallas_ivf.pick_bb(window, dim, itemsize, u)


@pytest.mark.parametrize("kw", [
    dict(platform="cuda", quantized=False, window=256, dim=384, qc=16, shadow=None),
    dict(platform="cpu", quantized=False, window=256, dim=384, qc=16, shadow=None),
    dict(platform="cpu", quantized=False, window=256, dim=384, qc=16, shadow=None,
         interpret=True),
    dict(platform="cuda", quantized=True, window=256, dim=384, qc=16, shadow=None),
    dict(platform="cuda", quantized=False, window=192, dim=384, qc=16, shadow=None),
    dict(platform="cuda", quantized=False, window=256, dim=100, qc=16, shadow=None),
    dict(platform="cuda", quantized=False, window=256, dim=384, qc=8, shadow=None),
    dict(platform="cuda", quantized=False, window=256, dim=384, qc=16, shadow=True),
])
def test_kernel_eligible_mirrors_pallas_eligible(pallas_ivf, kw):
    jkw = dict(kw, platform={"cuda": "tpu"}.get(kw["platform"], kw["platform"]))
    assert U.kernel_eligible(**kw) == pallas_ivf.pallas_eligible(**jkw)


def test_cpu_tensor_takes_the_plain_version(rng):
    inp = _inputs(rng, chunks=1)
    kw = dict(window=WINDOW, cap=2, metric="L2", variant=1, ktop=0)
    before = U.union_scan.launches
    a = _torch(inp, "float32", fn=U.union_scan, **kw)
    assert U.union_scan.launches == before
    assert torch.equal(a, _torch(inp, "float32", **kw))
    with pytest.raises(ValueError, match="variant-2"):
        _torch(inp, "float32", fn=U.union_scan, **dict(kw, ktop=5))


@pytest.mark.parametrize("base,u,capacity", [
    (1, 130, 264), (256, 130, 132), (4, 8, 528), (32, 1, 264),
])
def test_plan_splits_covers_union(base, u, capacity):
    per, n = U.plan_splits(base, u, capacity)
    assert (n - 1) * per < u <= n * per
    assert n <= u


@pytest.mark.parametrize("qc,block_queries", [
    (1, 128), (16, 128), (127, 128), (128, 128), (129, 128), (1000, 128), (40, 16), (16, 16),
])
def test_query_tiles_cover_each_chunk_once(qc, block_queries):
    """Stage 1's query tiles of a chunk (grid z): consecutive, whole tiles
    but the last, every query in exactly one, none empty."""
    tiles = U.query_tiles(qc, block_queries)
    assert len(tiles) == -(-qc // block_queries)
    covered = [q for q0, n in tiles for q in range(q0, q0 + n)]
    assert covered == list(range(qc))
    assert all(0 < n <= block_queries for _, n in tiles)
    assert all(n == block_queries for _, n in tiles[:-1])


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,ktop", [(1, 0), (2, 0), (2, 10), (2, 16)])
@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks,qc,u,window,d,cap", [
    (1, 16, 10, 256, 384, 2), (3, 40, 130, 128, 128, 2), (2, 128, 20, 256, 384, 3),
    (1, 16, 1, 128, 256, 1), (2, 130, 12, 256, 384, 4), (1, 200, 5, 128, 512, 2),
    (3, 128, 33, 256, 384, 2),
])
def test_kernel_matches_plain_on_card(rng, cuda, variant, ktop, metric, dtype,
                                      chunks, qc, u, window, d, cap):
    """Kernel vs plain on the same card tensors. The two sum the same float32
    products in different orders (bf16 storage: tensor cores against the
    plain float32 product), so packed values may differ in their low bits:
    decoded values agree to rtol 1e-4 / atol 1e-3 (D = 384 sums of products
    of unit normals reach ~60), and ids may differ only where the values
    tie. Chunks of 130 and 200 queries span two tensor-core query tiles;
    bf16 at D = 512 takes the FMA kernel (the tensor-core block's shared
    memory holds D <= 440)."""
    nlist = max(u + 2, 8)
    inp = _inputs(rng, chunks=chunks, qc=qc, u=u, nlist=nlist, window=window, d=d,
                  dtype=dtype)
    kw = dict(window=window, cap=cap, metric=metric, variant=variant, ktop=ktop)
    before = U.union_scan.launches
    kout = _torch(inp, dtype, fn=U.union_scan, device=cuda, **kw)
    torch.cuda.synchronize()
    assert U.union_scan.launches == before + 1
    pout = _torch(inp, dtype, device=cuda, **kw)
    k = ktop or 10
    kv, ki = _decode_port(kout, inp, k, window)
    pv, pi = _decode_port(pout, inp, k, window)
    np.testing.assert_allclose(kv, pv, rtol=1e-4, atol=1e-3)
    diff = ki != pi
    assert np.allclose(kv[diff], pv[diff], rtol=1e-4, atol=1e-3)
    if not ktop:  # every bin: all cap*window candidates, ranked
        kv, _ = _decode_port(kout, inp, cap * window, window)
        pv, _ = _decode_port(pout, inp, cap * window, window)
        np.testing.assert_allclose(kv, pv, rtol=1e-4, atol=1e-3)
