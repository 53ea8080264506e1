"""The union-scan stage probe (K6) vs the JAX script.

``benchmarks/pallas_kernel_probe.py`` runs its whole benchmark when it is
imported, so its ``make_kernel`` is loaded from the untouched file by
``ast`` into a namespace with small constants (NLIST 16, WINDOW 128, DIM
128, QC 8, U 8, BB 4, CAP 2, CHUNKS 2) and called through ``pallas_call``
in interpret mode, with ``build``'s block specs.

For each variant, ``probe_reference`` (the plain version of
``csrc/kernel_probe.cu``) is held to the JAX kernel as
``tests/test_torch_union_scan.py`` holds K2: the packed ints are decoded
into value and block index; block indices equal, values to rtol 1e-5 (the
two sides sum the same exact float32 products in different orders).
``chain`` and ``temps`` are equal bit for bit; ``temps_f32`` is all INIT on
the script's negative-score data on both sides and agrees with JAX on data
with positive scores. The JAX package on the CPU flushes subnormals, the
port keeps them, so the negative-subnormal (NaN) case is held to the
port's own contract only.

The ``cuda`` tests hold the kernel to its plain version on the card (the
tensor-core block to float32 rounding, each value carrying its own float64
score; the FMA block bit for bit) and skip without one. They import no JAX:
``python -m pytest tests/test_torch_kernel_probe.py -m cuda --noconftest -q``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.benchmarks import kernel_probe as B
from rag_faiss_embedding_tpu_torch.ops import kernel_probe as KP
from rag_faiss_embedding_tpu_torch.ops.distance import NEG_INF
from rag_faiss_embedding_tpu_torch.ops.union_scan import (
    init_packed, packing_bits, unmonotone_f32)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "benchmarks" / "pallas_kernel_probe.py"
NLIST, WINDOW, DIM, QC, U, BB, CAP, CHUNKS = 16, 128, 128, 8, 8, 4, 2, 2
NBITS = packing_bits(U)
MASK = (1 << NBITS) - 1
INIT = init_packed(NBITS)


@pytest.fixture(scope="module")
def jax_probe():
    """The script's ``make_kernel`` behind ``build``'s grid and block specs,
    in interpret mode: ``jax_probe(variant, u_all, qs, codes3, aux3)``."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from rag_faiss_embedding_tpu.ops.distance import NEG_INF
    from rag_faiss_embedding_tpu.ops.pallas_scan import _monotone_i32

    tree = ast.parse(SCRIPT.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_kernel"]
    ns = dict(jax=jax, jnp=jnp, lax=lax, pl=pl, pltpu=pltpu, NEG_INF=NEG_INF,
              _monotone_i32=_monotone_i32, NLIST=NLIST, WINDOW=WINDOW, DIM=DIM, QC=QC,
              U=U, BB=BB, CAP=CAP, CHUNKS=CHUNKS, NBITS=NBITS, MASK=MASK, INIT=INIT)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPT), "exec"), ns)

    def run(variant, u_all, qs, codes3, aux3):
        in_specs = [pl.BlockSpec((1, QC, DIM), lambda c, b, u_pre: (c, 0, 0))]
        for j in range(BB):
            in_specs.append(pl.BlockSpec(
                (1, WINDOW, DIM), lambda c, b, u_pre, j=j: (u_pre[c, b * BB + j], 0, 0)))
        for j in range(BB):
            in_specs.append(pl.BlockSpec(
                (1, 2, WINDOW), lambda c, b, u_pre, j=j: (u_pre[c, b * BB + j], 0, 0)))
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(CHUNKS, U // BB), in_specs=in_specs,
            out_specs=pl.BlockSpec((1, QC, CAP * WINDOW), lambda c, b, u_pre: (c, 0, 0)),
            scratch_shapes=[pltpu.VMEM((CAP, QC, WINDOW), jnp.int32)])
        call = pl.pallas_call(
            ns["make_kernel"](variant), grid_spec=grid_spec, interpret=True,
            out_shape=jax.ShapeDtypeStruct((CHUNKS, QC, CAP * WINDOW), jnp.int32))
        codes = jnp.asarray(codes3, jnp.bfloat16)
        aux = jnp.asarray(aux3)
        return np.asarray(call(jnp.asarray(u_all), jnp.asarray(qs, jnp.bfloat16),
                               *([codes] * BB), *([aux] * BB)))

    return run


def _inputs(seed=0, positive=False, nlist=NLIST, window=WINDOW, dim=DIM, qc=QC, u=U,
            chunks=CHUNKS):
    """The script's distribution (N(0, 1) rows and queries, norms |N| * 300 +
    100, ids 1: every score negative), or with ``positive`` |N| rows and
    queries and norms |N| (every score positive); bf16-representable."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    codes = bf(rng.standard_normal((nlist + 1, window, dim)))
    qs = bf(rng.standard_normal((chunks, qc, dim)))
    norms = np.abs(rng.standard_normal((nlist + 1, 1, window))).astype(np.float32)
    if positive:
        codes, qs = np.abs(codes), np.abs(qs)
    else:
        norms = norms * 300 + 100
    aux3 = np.concatenate([norms.view(np.int32), np.ones((nlist + 1, 1, window), np.int32)], 1)
    u_all = np.stack([np.sort(rng.permutation(nlist)[:u]) for _ in range(chunks)])
    return u_all.astype(np.int32), qs, codes, aux3


def _port(variant, inp, fn=KP.probe_reference, device="cpu", bb=BB, cap=CAP):
    u_all, qs, codes, aux3 = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in inp)
    return fn(variant, u_all, qs.bfloat16(), codes.bfloat16(), aux3, bb=bb, cap=cap).cpu().numpy()


def _decode(packed):
    """(values, block index) of packed ints."""
    t = torch.from_numpy(np.array(packed))
    return unmonotone_f32(t & ~MASK).numpy(), (t & MASK).numpy()


@pytest.mark.parametrize("positive", [False, True], ids=["negative", "positive"])
@pytest.mark.parametrize("variant", KP.VARIANTS)
def test_reference_matches_pallas(jax_probe, variant, positive):
    inp = _inputs(positive=positive)
    j = jax_probe(variant, *inp)
    p = _port(variant, inp)
    assert p.shape == j.shape == (CHUNKS, QC, CAP * WINDOW) and p.dtype == np.int32
    (jv, jb), (pv, pb) = _decode(j), _decode(p)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    if variant == "none":
        assert (pb == U - 1).all()
        np.testing.assert_array_equal(p[..., :WINDOW], p[..., WINDOW:])
    if variant == "temps_f32" and not positive:  # negative floats order backwards
        assert (p == INIT).all() and (j == INIT).all()
    if positive:
        assert (pv > 0).all()


@pytest.mark.parametrize("positive", [False, True], ids=["negative", "positive"])
def test_chain_equals_temps_bit_for_bit(positive):
    inp = _inputs(seed=3, positive=positive)
    chain = _port("chain", inp)
    np.testing.assert_array_equal(chain, _port("temps", inp))
    assert (chain != INIT).all()
    if positive:  # positive floats order as their bits do
        np.testing.assert_array_equal(chain, _port("temps_f32", inp))


def test_temps_f32_keeps_a_subnormal_score_as_nan():
    """A zero query row against a norm of 1e-39 scores -1e-39, a negative
    subnormal: its packed int reads as a NaN, which the float chain keeps in
    both levels of that bin from its block on (jnp.maximum semantics)."""
    u_all, qs, codes, aux3 = _inputs(seed=5)
    qs[0, 0] = 0.0
    blk, slot = u_all[0, 2], 7
    norms = aux3[:, 0].view(np.float32)
    norms[blk, slot] = np.float32(1e-39)
    p = _port("temps_f32", (u_all, qs, codes, aux3))
    bits = p[0, 0, [slot, WINDOW + slot]]
    assert np.isnan(bits.view(np.float32)).all()
    assert (bits == bits[0]).all() and (int(bits[0]) & MASK) == 2
    chain = _port("chain", (u_all, qs, codes, aux3))
    assert chain[0, 0, slot] == bits[0]  # as an int it is the bin's largest


@pytest.mark.parametrize("kw,match", [
    (dict(variant="fast"), "variant"), (dict(bb=3), "multiple of bb"),
    (dict(cap=0), "cap"), (dict(cap=5), "cap"),
])
def test_argument_checks(kw, match):
    inp = _inputs()
    args = {"variant": "chain", "bb": BB, "cap": CAP, **kw}
    with pytest.raises(ValueError, match=match):
        _port(args.pop("variant"), inp, **args)


def test_cpu_tensor_takes_the_plain_version():
    inp = _inputs()
    before = KP.probe.launches
    for variant in KP.VARIANTS:
        a = _port(variant, inp, fn=KP.probe)
        np.testing.assert_array_equal(a, _port(variant, inp))
    assert KP.probe.launches == before


def test_make_inputs_follows_the_script():
    inp = B.make_inputs(device="cpu", nlist=32, window=64, dim=16, qc=8, u=20, chunks=3)
    assert inp["codes3"].shape == (33, 64, 16) and inp["codes3"].dtype == torch.bfloat16
    assert inp["qs"].shape == (3, 8, 16) and inp["qs"].dtype == torch.bfloat16
    norms = inp["aux3"][:, 0].view(torch.float32)
    assert inp["aux3"].shape == (33, 2, 64) and bool((norms >= 100).all())
    assert bool((inp["aux3"][:, 1] == 1).all())
    u = inp["u_all"]
    assert u.shape == (3, 20) and u.dtype == torch.int32
    assert bool((u[:, 1:] > u[:, :-1]).all()) and int(u.max()) < 32
    again = B.make_inputs(device="cpu", nlist=32, window=64, dim=16, qc=8, u=20, chunks=3)
    assert all(torch.equal(inp[k], again[k]) for k in inp)


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_close_to_plain(inp, k, p, variant, rtol=1e-4):
    """The card's rule for the tensor-core block against the plain version
    (they sum the same exact bf16 products in different orders): bins that
    read as a float NaN are the same bins with the same bits; empty bins
    (NEG_INF) agree; values within rtol x (max ||q||^2 + max ||x||^2) +
    (rtol + two packing quanta) x |value|; every kernel value carries its
    own block's float64 score for its (query, slot), so block positions
    differ only at near-ties; ``none`` holds block U - 1 everywhere."""
    u_all, qs, codes, aux3 = inp
    u = u_all.shape[1]
    nbits = packing_bits(u)
    window = codes.shape[1]
    kn, pn = np.isnan(k.view(np.float32)), np.isnan(p.view(np.float32))
    np.testing.assert_array_equal(kn, pn)
    np.testing.assert_array_equal(k[kn], p[pn])
    mask = (1 << nbits) - 1
    t = torch.from_numpy(np.array(k))
    kv, kb = unmonotone_f32(t & ~mask).numpy(), (t & mask).numpy()
    t = torch.from_numpy(np.array(p))
    pv = unmonotone_f32(t & ~mask).numpy()
    live = ~kn & (kv > 0.5 * NEG_INF)
    np.testing.assert_array_equal(live, ~pn & (pv > 0.5 * NEG_INF))
    q64, x64 = qs.astype(np.float64), codes.astype(np.float64)
    atol = rtol * float((q64 ** 2).sum(-1).max() + (x64 ** 2).sum(-1).max())
    rel = rtol + 2.0 ** (nbits - 22)
    assert (np.abs(kv - pv)[live] <= atol + rel * np.abs(pv)[live]).all()
    rsq = aux3[:, 0].view(np.float32).astype(np.float64)
    slot = np.arange(k.shape[-1]) % window
    for c in range(u_all.shape[0]):
        blk = u_all[c][kb[c]]                                   # (qc, cap * window)
        own = 2 * np.einsum("qd,qsd->qs", q64[c], x64[blk, slot]) - rsq[blk, slot]
        own = np.where(aux3[blk, 1, slot] >= 0, own, NEG_INF)
        lc = live[c]
        assert (np.abs(kv[c] - own)[lc] <= atol + rel * np.abs(own)[lc]).all()
    if variant == "none":
        assert (kb == u - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", KP.VARIANTS)
@pytest.mark.parametrize("positive", [False, True], ids=["negative", "positive"])
@pytest.mark.parametrize("shape", [
    dict(nlist=16, window=128, dim=128, qc=8, u=8, chunks=2, bb=4, cap=2),
    dict(nlist=40, window=256, dim=384, qc=40, u=30, chunks=3, bb=10, cap=3),
    dict(nlist=12, window=64, dim=64, qc=17, u=1, chunks=1, bb=1, cap=1),
    dict(nlist=64, window=128, dim=256, qc=16, u=48, chunks=2, bb=16, cap=4),
    dict(nlist=20, window=64, dim=384, qc=200, u=12, chunks=2, bb=4, cap=2),
    dict(nlist=16, window=64, dim=72, qc=20, u=8, chunks=2, bb=4, cap=2),
])
def test_kernel_matches_plain_on_card(cuda, variant, positive, shape):
    """Kernel vs plain on the same card tensors. The tensor-core block is
    held to ``_assert_close_to_plain``; D = 72 (not a multiple of 16) takes
    the FMA block, which sums in the plain version's order: bit for bit. A
    chunk of 200 queries spans two tensor-core query tiles."""
    shape = dict(shape)
    bb, cap = shape.pop("bb"), shape.pop("cap")
    inp = _inputs(positive=positive, **shape)
    before = KP.probe.launches
    k = _port(variant, inp, fn=KP.probe, device=cuda, bb=bb, cap=cap)
    torch.cuda.synchronize()
    assert KP.probe.launches == before + 1
    p = _port(variant, inp, device=cuda, bb=bb, cap=cap)
    tc = KP.uses_tensor_cores(torch.cuda.current_device(), shape["dim"], cap)
    assert tc == (shape["dim"] % 16 == 0)
    if tc:
        _assert_close_to_plain(inp, k, p, variant)
    else:
        np.testing.assert_array_equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("positive", [False, True], ids=["negative", "positive"])
def test_kernel_chain_equals_temps_on_card(cuda, positive):
    """``chain`` and ``temps`` run the same chain on the same scores: the
    card gives them the same bits, and the same as ``temps_f32`` where every
    score is positive."""
    inp = _inputs(seed=3, positive=positive, nlist=40, window=256, dim=384, qc=40, u=30,
                  chunks=3)
    chain = _port("chain", inp, fn=KP.probe, device=cuda, bb=10, cap=3)
    np.testing.assert_array_equal(chain, _port("temps", inp, fn=KP.probe, device=cuda, bb=10,
                                               cap=3))
    if positive:
        np.testing.assert_array_equal(chain, _port("temps_f32", inp, fn=KP.probe, device=cuda,
                                                   bb=10, cap=3))


@pytest.mark.cuda
def test_kernel_keeps_the_subnormal_nan_on_card(cuda):
    u_all, qs, codes, aux3 = _inputs(seed=5)
    qs[0, 0] = 0.0
    aux3[:, 0].view(np.float32)[u_all[0, 2], 7] = np.float32(1e-39)
    inp = (u_all, qs, codes, aux3)
    for variant in KP.VARIANTS:
        k = _port(variant, inp, fn=KP.probe, device=cuda)
        _assert_close_to_plain(inp, k, _port(variant, inp, device=cuda), variant)
    assert np.isnan(k[0, 0, [7, WINDOW + 7]].view(np.float32)).all()
