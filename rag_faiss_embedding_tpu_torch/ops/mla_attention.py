"""Causal prefill attention of DeepSeek-V2's latent attention (MLA): the
CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package has no DeepSeek model. ``models/
deepseek_v2.py``'s prefill calls ``mla_prefill_attention`` once a layer
(``models/kimi_linear.py``'s, through it, once an MLA layer: 32 heads, q_pe
and k_pe unrotated, NoPE) with the operands where it has them: ``q_nope``
[n, H, 128] (a strided view of the layer's first product), ``q_pe`` [n, H,
64] (the roped queries; NoPE's a strided view of the same product),
``k_nope`` and ``v`` [n, H, 128] (the two halves of ``W_kvb c_kv``, strided
views), and ``k_pe`` [n, 64], the one rope key all heads share. Each query
row attends to every key at or before its position; the result is
``o`` [n, H * v_width], contiguous, in the operands' dtype.

- On a CUDA tensor it launches ``csrc/mla_prefill_attention.cu`` (built on
  first use by ``_build``) or raises: the kernel takes bf16 operands at
  MLA's widths (q / k 128 + 64, v 128), a unit column stride, other strides
  in multiples of 8 elements and 16-byte aligned pointers
  (``check_kernel_operands`` names what it refuses). No path runs the
  generator in float32 on the card.
- On a CPU tensor it runs ``mla_prefill_attention_reference``: the same
  causal attention in plain torch, in blocks of ``QUERY_BLOCK`` query rows,
  at any widths and in float32 or bf16.

Numerics of both: float32 scores and softmax; the probabilities rounded to
the operands' dtype before they weight ``v`` (a no-op in float32), float32
sums, the output in the operands' dtype.

``mla_prefill_attention.launches`` counts kernel launches, so a run can show
that its prefills went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

# the widths the kernel is built for: DeepSeek-V2's qk_nope_head_dim,
# qk_rope_head_dim and v_head_dim (every published DeepSeek-V2 config)
NOPE, ROPE, V_WIDTH = 128, 64, 128
# query rows a step of the plain version: its scores are heads x this x n
QUERY_BLOCK = 256


def mla_prefill_attention_reference(q_nope: torch.Tensor, q_pe: torch.Tensor,
                                    k_nope: torch.Tensor, k_pe: torch.Tensor,
                                    v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain torch version of the kernel, on any device and at any widths."""
    n, heads, dv = v.shape
    dtype = v.dtype
    out = torch.empty(n, heads * dv, dtype=dtype, device=v.device)
    kn = k_nope.float().transpose(0, 1)  # [heads, n, nope]
    kp = k_pe.float()  # [n, rope]
    vv = v.float().transpose(0, 1)  # [heads, n, dv]
    keys = torch.arange(n, device=v.device)
    for a in range(0, n, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, n)
        s = (q_nope[a:b].float().transpose(0, 1) @ kn[:, :b].transpose(1, 2)
             + (q_pe[a:b].float() @ kp[:b].t()).transpose(0, 1)) * scale  # [heads, rows, b]
        s.masked_fill_(keys[a:b, None] < keys[None, :b], float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (p.to(dtype).float() @ vv[:, :b]) / p.sum(-1, keepdim=True)
        out[a:b] = o.transpose(0, 1).reshape(b - a, -1).to(dtype)
    return out


def check_kernel_operands(q_nope, q_pe, k_nope, k_pe, v) -> None:
    """Raise ``ValueError`` on what the kernel does not take: another dtype
    than bf16, other widths than 128 / 64 / 128, a column stride other than
    1, other strides not multiples of 8 elements, or a pointer not 16-byte
    aligned (TMA's rules). Needs no card."""
    ops = {"q_nope": q_nope, "q_pe": q_pe, "k_nope": k_nope, "k_pe": k_pe, "v": v}
    dtypes = {name: t.dtype for name, t in ops.items() if t.dtype != torch.bfloat16}
    if dtypes:
        raise ValueError(f"the MLA prefill kernel takes bfloat16 operands, got {dtypes}")
    widths = (q_nope.shape[-1], q_pe.shape[-1], v.shape[-1])
    if widths != (NOPE, ROPE, V_WIDTH):
        raise ValueError(f"the MLA prefill kernel takes q / k widths {NOPE} + {ROPE} and "
                         f"v {V_WIDTH}, got {widths[0]} + {widths[1]} and {widths[2]}")
    for name, t in ops.items():
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"the MLA prefill kernel takes {name} with unit column stride, "
                             f"other strides in multiples of 8 and a 16-byte aligned start, "
                             f"got strides {t.stride()} at {t.data_ptr():#x}")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry
    point."""
    lib = _build.load("mla_prefill_attention")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rfe_mla_prefill_attention.argtypes = ([vp] * 6 + [ci] * 2 + [cl] * 9
                                              + [ctypes.c_float, vp])
    lib.rfe_mla_prefill_attention.restype = ci
    lib.rfe_mla_attention_error_string.argtypes = [ci]
    lib.rfe_mla_attention_error_string.restype = ctypes.c_char_p
    return lib


def mla_prefill_attention(q_nope: torch.Tensor, q_pe: torch.Tensor, k_nope: torch.Tensor,
                          k_pe: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention of one prefill layer: ``softmax(q k^T * scale) v``
    with ``q = [q_nope, q_pe]`` per head and ``k = [k_nope, k_pe]``, ``k_pe``
    shared by the heads; ``o`` [n, heads * v width], contiguous."""
    n, heads, _ = q_nope.shape
    shapes = {"q_pe": (q_pe.shape, (n, heads, q_pe.shape[-1])),
              "k_nope": (k_nope.shape, q_nope.shape),
              "k_pe": (k_pe.shape, (n, q_pe.shape[-1])),
              "v": (v.shape, (n, heads, v.shape[-1]))}
    bad = {name: tuple(got) for name, (got, want) in shapes.items() if tuple(got) != tuple(want)}
    if bad:
        raise ValueError(f"q_nope is {tuple(q_nope.shape)}; operands of other shapes: {bad}")
    if q_nope.device.type != "cuda":
        return mla_prefill_attention_reference(q_nope, q_pe, k_nope, k_pe, v, scale)
    check_kernel_operands(q_nope, q_pe, k_nope, k_pe, v)
    dev = q_nope.device
    out = torch.empty(n, heads * V_WIDTH, dtype=torch.bfloat16, device=dev)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(dev):
        err = lib.rfe_mla_prefill_attention(
            q_nope.data_ptr(), q_pe.data_ptr(), k_nope.data_ptr(), k_pe.data_ptr(),
            v.data_ptr(), out.data_ptr(), n, heads,
            q_nope.stride(0), q_nope.stride(1), q_pe.stride(0), q_pe.stride(1),
            k_nope.stride(0), k_nope.stride(1), k_pe.stride(0), v.stride(0), v.stride(1),
            scale * math.log2(math.e), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mla_prefill_attention kernel launch failed: "
                           + lib.rfe_mla_attention_error_string(err).decode())
    mla_prefill_attention.launches += 1
    return out


mla_prefill_attention.launches = 0
