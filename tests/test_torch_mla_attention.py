"""The MLA prefill attention (``ops/mla_attention.py``): its plain version
against the formulation it replaced, its refusals, and on the card the
kernel (``csrc/mla_prefill_attention.cu``) against the plain version.

The operands are made as ``DeepseekV2._attend_prefill`` makes them, at
DeepSeek-V2-Lite's widths: ``q_nope`` a strided view of the layer's first
product (row stride 3,648), ``q_pe`` [n, 16, 64], ``k_nope`` and ``v`` the
two halves of ``kv`` [n, 16, 256], ``k_pe`` the last 64 columns of the
[n, 576] cache rows.

Tolerances. Plain version against SDPA's math over v padded to 192, both
float32 on the CPU: the same sums in other orders, atol / rtol 1e-5 (seen:
7.7e-6 at n 300 on outputs up to 3.7). Kernel against plain version, both
bf16 on the card: each rounds its probabilities to bf16 (the kernel against
its running row maximum, the plain version against the final one) and its
output to bf16, so a row may differ by an output rounding (2^-8 of its
largest value) plus the probabilities' (2^-9 of a weight each): every row's
relative L2 difference <= 1e-2 and every value within 2^-6 of its row's
largest.

The card tests skip without an NVIDIA GPU and import no JAX:
``python -m pytest tests/test_torch_mla_attention.py -m cuda --noconftest -q``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from rag_faiss_embedding_tpu_torch.models.deepseek_v2 import DeepseekV2Config
from rag_faiss_embedding_tpu_torch.ops import mla_attention as A

HEADS = 16
SCALE = DeepseekV2Config().softmax_scale
QA_WIDTH = HEADS * 128 + 512 + HEADS * 64 + 64  # the stacked q_proj / kv_a product


def _operands(n, dtype=torch.float32, device="cpu", seed=0):
    """(q_nope, q_pe, k_nope, k_pe, v) laid out as ``_attend_prefill`` has
    them."""
    g = torch.Generator(device=device).manual_seed(seed)
    qa = torch.randn(n, QA_WIDTH, generator=g, device=device).to(dtype)
    q_pe = torch.randn(n, HEADS, 64, generator=g, device=device).to(dtype)
    rows = torch.randn(n, 576, generator=g, device=device).to(dtype)
    kv = torch.randn(n, HEADS, 256, generator=g, device=device).to(dtype)
    k_nope, v = kv.split([128, 128], -1)
    return qa[:, : HEADS * 128].view(n, HEADS, 128), q_pe, k_nope, rows[:, 512:], v


def _sdpa_padded(q_nope, q_pe, k_nope, k_pe, v, scale):
    """The formulation the kernel replaced: q and k concatenated, the rope
    key expanded to every head, v padded to 192, SDPA, the 128 columns
    sliced back."""
    n = q_nope.shape[0]
    q = torch.cat((q_nope, q_pe), -1).transpose(0, 1)
    k = torch.cat((k_nope, k_pe[:, None].expand(n, HEADS, 64)), -1).transpose(0, 1)
    vp = F.pad(v, (0, 64)).transpose(0, 1)
    with sdpa_kernel([SDPBackend.MATH]):
        o = F.scaled_dot_product_attention(q[None], k[None], vp[None], is_causal=True,
                                           scale=scale)[0, ..., :128]
    return o.transpose(0, 1).reshape(n, -1)


@pytest.mark.parametrize("n", [1, 7, 64, 129, 300])
def test_plain_version_matches_sdpa_over_padded_v(n):
    ops = _operands(n, seed=n)
    got = A.mla_prefill_attention(*ops, SCALE)
    assert got.shape == (n, HEADS * 128) and got.is_contiguous()
    torch.testing.assert_close(got, _sdpa_padded(*ops, SCALE), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [1, 5, 64])
def test_plain_version_does_not_depend_on_its_query_blocks(block, monkeypatch):
    ops = _operands(150, seed=block)
    want = A.mla_prefill_attention_reference(*ops, SCALE)
    monkeypatch.setattr(A, "QUERY_BLOCK", block)
    got = A.mla_prefill_attention_reference(*ops, SCALE)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_cpu_path_launches_nothing():
    before = A.mla_prefill_attention.launches
    A.mla_prefill_attention(*_operands(40), SCALE)
    assert A.mla_prefill_attention.launches == before


def _views_bf16(n=32):
    return list(_operands(n, torch.bfloat16))


def _float32(ops):
    ops[4] = ops[4].float()
    return ops


def _narrow_nope(ops):
    ops[0], ops[2] = ops[0][..., :64], ops[2][..., :64]
    return ops


def _wide_v(ops):
    ops[4] = torch.zeros(ops[4].shape[0], HEADS, 192, dtype=torch.bfloat16)
    return ops


def _strided_columns(ops):
    n = ops[1].shape[0]
    ops[1] = torch.zeros(n, HEADS, 128, dtype=torch.bfloat16)[..., ::2]
    return ops


def _odd_row_stride(ops):
    n = ops[3].shape[0]
    ops[3] = torch.zeros(n, 65, dtype=torch.bfloat16)[:, :64]
    return ops


@pytest.mark.parametrize("fault,words", [
    (_float32, "bfloat16"), (_narrow_nope, "widths"), (_wide_v, "widths"),
    (_strided_columns, "unit column stride"), (_odd_row_stride, "multiples of 8")])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(fault, words):
    A.check_kernel_operands(*_views_bf16())  # the prefill's own views pass
    with pytest.raises(ValueError, match=words):
        A.check_kernel_operands(*fault(_views_bf16()))


def test_operands_of_other_shapes_raise_on_any_device():
    q_nope, q_pe, k_nope, k_pe, v = _operands(20)
    with pytest.raises(ValueError, match="k_pe"):
        A.mla_prefill_attention(q_nope, q_pe, k_nope, k_pe[:19], v, SCALE)
    with pytest.raises(ValueError, match="v"):
        A.mla_prefill_attention(q_nope, q_pe, k_nope, k_pe, v[:, :8], SCALE)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_rows_close(got, want):
    got, want = got.float(), want.float()
    scale = want.abs().amax(-1, keepdim=True)
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert rel.max().item() <= 1e-2, rel.max().item()
    assert ((got - want).abs() <= scale * 2.0 ** -6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 1000, 4097, 16896])
def test_kernel_matches_plain_version(cuda, n):
    ops = _operands(n, torch.bfloat16, cuda, seed=n)
    before = A.mla_prefill_attention.launches
    got = A.mla_prefill_attention(*ops, SCALE)
    torch.cuda.synchronize()
    assert A.mla_prefill_attention.launches == before + 1
    assert got.shape == (n, HEADS * 128) and got.dtype == torch.bfloat16
    assert got.is_contiguous() and torch.isfinite(got).all()
    _assert_rows_close(got, A.mla_prefill_attention_reference(*ops, SCALE))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1000, 333), (1000, 384), (300, 1)])
def test_keys_after_a_query_change_nothing_before_it(cuda, n, t):
    ops = _operands(n, torch.bfloat16, cuda, seed=t)
    want = A.mla_prefill_attention(*ops, SCALE)
    q_nope, q_pe, k_nope, k_pe, v = ops
    for x in (k_nope, k_pe, v, q_nope, q_pe):
        x[t:] = 3.0 - x[t:]
    got = A.mla_prefill_attention(*ops, SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got[:t], want[:t])
    assert not torch.equal(got[t:], want[t:])


@pytest.mark.cuda
def test_the_card_refuses_float32(cuda):
    with pytest.raises(ValueError, match="bfloat16"):
        A.mla_prefill_attention(*_operands(16, torch.float32, cuda), SCALE)
