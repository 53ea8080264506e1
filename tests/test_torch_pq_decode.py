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
