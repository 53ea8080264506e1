"""Kimi Delta Attention (KDA): the chunked prefill, its state pass (the CUDA
kernel and its plain twin), and the one-token decode step (the CUDA kernel
and its plain twin).

Replaces no TPU kernel: the JAX package has no Kimi model. ``models/
kimi_linear.py`` calls ``kda_chunked`` once a KDA layer in a prefill and
``kda_decode_step`` once a KDA layer in a decode step.

Per head, with ``q`` already l2-normalised and scaled by ``K^-1/2``, ``k``
l2-normalised, ``g`` the log-decay of each key channel (``g <= 0``) and
``beta`` in (0, 1), the state ``S`` [K, V] follows the gated delta rule of
the Kimi Linear report (arXiv:2510.26692, eq. 1; flash-linear-attention's
``naive_recurrent_kda``)::

    S <- Diag(exp g_t) S;   S <- S + beta_t k_t (v_t - S^T k_t)^T;   o_t = S^T q_t

The chunked form (chunks of ``CHUNK`` rows, all float32). Within a chunk
let ``G_t`` be the running sum of ``g`` through row ``t``, ``P[t, s] =
sum_d q_t k_s exp(G_t - G_s)`` for ``s <= t`` and ``A[t, s] = beta_t sum_d
k_t k_s exp(G_t - G_s)`` for ``s < t``. Then, with ``T = (I + A)^-1`` (a
unit lower triangular solve), the chunk's WY keys ``W = T beta (k e^G)``
and values ``U0 = T beta v``, the state pass from the chunk's first state
``S`` is::

    U = U0 - W S;   O = P U0 + (q e^G - P W) S;   S <- e^{G_C} S + (k e^{G_C - G})^T U

Everything but the pass runs in parallel over all chunks as batched torch
products. The decays inside ``P`` and ``A`` are taken in row blocks of
``SUB`` rows, both sides relative to the block's middle row ``m``:
``(q_t e^{G_t - G_m}) . (k_s e^{G_m - G_s})``, each factor at most
``e^{8 |g|}`` for 8 rows of decay, so no factor over- or underflows while
no channel decays by more than ``e^-EXP_MAX`` over 8 rows (the exponents
are clipped at ``EXP_MAX``, where the form stops being exact). Every other
factor (``e^G``, ``e^{G_C - G}``, ``e^{G_C}``) is at most 1.

``kda_state_pass`` runs the pass: on a CUDA tensor the kernel
``csrc/kda_state_pass.cu`` (one launch a layer; each block owns one head
and 32 of the 128 value columns and keeps its float32 slice of the state in
shared memory through all chunks), on a CPU tensor its plain twin
``kda_state_pass_reference``, a loop over the chunks with the same
contract. ``kda_state_pass.launches`` counts the kernel's launches.

``kda_decode_step`` runs one token through a layer after its projections:
the convolutions over the kept inputs and this one, SiLU, the l2 norms,
one step of the recurrence (``kda_step``) and the gated RMSNorm of the
output. On a CUDA tensor it is one launch (``csrc/kda_state_pass.cu``'s
second kernel, one block a head) where plain torch takes ~30 small ones:
a decode step runs ~2,000 kernels of a few microseconds each, so their
number sets its time; on a CPU tensor, its twin
``kda_decode_step_reference``. ``kda_decode_step.launches`` counts the
kernel's launches from the host: a step run outside a graph, or captured
into one (a replay of the graph launches it again and is not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

CHUNK = 64  # rows a chunk: the kernel's C
SUB = 16  # rows of a block of the intra-chunk decays
EXP_MAX = 80.0  # exponents clipped here: e^80 is far inside float32
L2_EPS = 1e-6  # fla's l2norm: x / sqrt(sum x^2 + eps)
WIDTH = 128  # the kernel's key and value widths (Kimi-Linear's head_dim)


# ---------------------------------------------------------------- the pass
def kda_state_pass_reference(w, qp, kh, u0, o0, gamma, s0):
    """The pass in plain torch (the kernel's twin): ``w``, ``qp``, ``kh``
    [H, NC, C, K], ``u0``, ``o0`` [H, NC, C, V], ``gamma`` [H, NC, K],
    ``s0`` [H, K, V]; returns ``out`` [NC * C, H, V] and the last state."""
    h, nc, c, _ = u0.shape
    s = s0.clone()
    out = torch.empty(nc, c, h, u0.shape[-1], dtype=u0.dtype, device=u0.device)
    for j in range(nc):
        u = u0[:, j] - w[:, j] @ s
        out[j] = (o0[:, j] + qp[:, j] @ s).transpose(0, 1)
        s = gamma[:, j, :, None] * s + kh[:, j].transpose(1, 2) @ u
    return out.view(nc * c, h, -1), s


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and bind its entry point."""
    lib = _build.load("kda_state_pass")
    vp = ctypes.c_void_p
    lib.rfe_kda_state_pass.argtypes = [vp] * 9 + [ctypes.c_int] * 7 + [vp]
    lib.rfe_kda_state_pass.restype = ctypes.c_int
    lib.rfe_kda_decode_step.argtypes = [vp] * 8 + [ctypes.c_int] + [ctypes.c_float] * 3 + [vp]
    lib.rfe_kda_decode_step.restype = ctypes.c_int
    lib.rfe_kda_error_string.argtypes = [ctypes.c_int]
    lib.rfe_kda_error_string.restype = ctypes.c_char_p
    return lib


def _row_stride(t: torch.Tensor):
    """The even spacing of ``t``'s rows (of its last dimension) in elements,
    or None where they are not evenly spaced with unit columns."""
    h, nc, c, _ = t.shape
    rs = t.stride(2)
    even = t.stride(3) == 1 and (nc == 1 or t.stride(1) == c * rs) and (
        h == 1 or t.stride(0) == nc * c * rs)
    return rs if even else None


def check_kernel_operands(w, qp, kh, u0, o0, gamma, s0) -> None:
    """Raise ``ValueError`` on what the kernel does not take: other shapes
    than ``kda_state_pass_reference``'s at chunks of ``CHUNK`` and widths of
    ``WIDTH``, another dtype than float32, rows of w, qp, kh, u0 or o0 not
    evenly spaced at a multiple of 4 elements, gamma or s0 not contiguous,
    a pointer not 16-byte aligned. Needs no card."""
    h, nc = u0.shape[:2]
    rows = (h, nc, CHUNK, WIDTH)
    want = {"w": rows, "qp": rows, "kh": rows, "u0": rows, "o0": rows, "gamma": (h, nc, WIDTH),
            "s0": (h, WIDTH, WIDTH)}
    ops = {"w": w, "qp": qp, "kh": kh, "u0": u0, "o0": o0, "gamma": gamma, "s0": s0}
    def takes(t, shape):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.data_ptr() % 16:
            return False
        if t.dim() != 4:
            return t.is_contiguous()
        rs = _row_stride(t)
        return rs is not None and rs % 4 == 0

    bad = {n: (tuple(t.shape), t.dtype, t.stride()) for n, t in ops.items()
           if not takes(t, want[n])}
    if bad:
        raise ValueError(f"the KDA state pass takes float32 operands {want} with evenly spaced "
                         f"rows (a multiple of 4 elements apart), got {bad}")


def kda_state_pass(w, qp, kh, u0, o0, gamma, s0, s_out=None):
    """The pass (layouts of ``kda_state_pass_reference``, float32; the rows
    of w, qp, kh, u0 and o0 evenly spaced); the last state goes to
    ``s_out`` where given (it may be ``s0``). Returns ``out`` [NC * C, H,
    V] and the last state."""
    h, nc, c, dv = u0.shape
    if u0.device.type != "cuda":
        out, s = kda_state_pass_reference(w, qp, kh, u0, o0, gamma, s0)
        return out, s if s_out is None else s_out.copy_(s)
    check_kernel_operands(w, qp, kh, u0, o0, gamma, s0)
    s_out = torch.empty_like(s0) if s_out is None else s_out
    out = torch.empty(nc * c, h, dv, dtype=torch.float32, device=u0.device)
    if nc == 0:
        return out, s_out.copy_(s0)
    lib = load()
    with torch.cuda.device(u0.device):
        err = lib.rfe_kda_state_pass(w.data_ptr(), qp.data_ptr(), kh.data_ptr(), u0.data_ptr(),
                                     o0.data_ptr(), gamma.data_ptr(), s0.data_ptr(),
                                     out.data_ptr(), s_out.data_ptr(), h, nc,
                                     *(_row_stride(t) for t in (w, qp, kh, u0, o0)),
                                     torch.cuda.current_stream(u0.device).cuda_stream)
    if err != 0:
        raise RuntimeError("kda_state_pass kernel launch failed: "
                           + lib.rfe_kda_error_string(err).decode())
    kda_state_pass.launches += 1
    return out, s_out


kda_state_pass.launches = 0


# ----------------------------------------------------- the intra-chunk part
def to_blocks(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Head-major rows ``x`` [H, n, D] (any strides) -> the chunked layout
    [H, n_pad / CHUNK, CHUNK, D], float32, contiguous, rows past n zero
    (they leave the state as it is: no decay, no key, no value)."""
    h, n, d = x.shape
    out = torch.empty(h, n_pad, d, dtype=torch.float32, device=x.device)
    out[:, :n] = x
    out[:, n:] = 0
    return out.view(h, -1, CHUNK, d)


def chunk_operands(q, k, v, g, beta):
    """The state pass's operands (``w, qp, kh, u0, o0, gamma``) from ``q``,
    ``k``, ``v``, ``g`` [H, NC, CHUNK, 128] and ``beta`` [H, NC, CHUNK, 1]
    in the chunked layout (``to_blocks``), float32. ``u0`` and ``w`` are
    the two halves of one solve's rows."""
    h, nc, c, dk = k.shape
    dv, sub = v.shape[-1], c // SUB
    G = g.cumsum(2)
    # each row block's decays relative to its middle row, then every row's
    # key relative to each block's middle row (past the block: masked)
    mid = G[:, :, SUB // 2 - 1::SUB, None]  # [H, NC, blocks, 1, K]
    up = (G.view(h, nc, sub, SUB, dk) - mid).clamp_(max=EXP_MAX).exp_()
    down = (mid - G[:, :, None]).clamp_(max=EXP_MAX).exp_().mul_(k[:, :, None])
    down = down.view(-1, c, dk).transpose(1, 2)  # [H NC blocks, K, C]
    ku = (k.view_as(up) * up).view(-1, SUB, dk)
    p = torch.bmm(up.mul_(q.view_as(up)).view(-1, SUB, dk), down).view(h, nc, c, c)
    a = torch.bmm(ku, down).view(h, nc, c, c)
    del up, down, ku
    t = torch.arange(c, device=G.device)
    p.masked_fill_(t[None] > t[:, None], 0.0)  # keep s <= t
    a.masked_fill_(t[None] >= t[:, None], 0.0).mul_(beta)  # keep s < t, row t times beta_t
    eg = G.exp()
    rhs = torch.empty(h, nc, c, dv + dk, device=G.device)
    torch.mul(v, beta, out=rhs[..., :dv])
    torch.mul(k, eg, out=rhs[..., dv:]).mul_(beta)
    # (LAPACK and cuBLAS leave each solution column-major: one copy to rows)
    sol = torch.linalg.solve_triangular(a, rhs, upper=False, unitriangular=True).contiguous()
    del rhs
    u0, w = sol[..., :dv], sol[..., dv:]
    pf = p.view(-1, c, c)
    qp = torch.baddbmm(eg.mul_(q).view(-1, c, dk), pf, w.view(-1, c, dk), alpha=-1.0)
    o0 = torch.bmm(pf, u0.view(-1, c, dv)).view(h, nc, c, dv)
    last = G[:, :, -1:]
    kh = (last - G).exp_().mul_(k)
    return w, qp.view(h, nc, c, dk), kh, u0, o0, last[:, :, 0].exp().contiguous()


def kda_chunked(q, k, v, g, beta, s_out: torch.Tensor):
    """One KDA layer's prefill from a zero state, its inputs in the chunked
    layout (``chunk_operands``): ``o`` [NC * CHUNK, H, V] float32, token-major
    (rows past the prompt's are not its); the last state is written to
    ``s_out`` [H, K, V]."""
    out, _ = kda_state_pass(*chunk_operands(q, k, v, g, beta), s_out.zero_(), s_out)
    return out


# ---------------------------------------------------------------- decode
def kda_step(state: torch.Tensor, q, k, v, g, beta) -> torch.Tensor:
    """One token through the recurrence, ``state`` [H, K, V] float32 updated
    in place; ``q``, ``k``, ``g`` [H, K], ``v`` [H, V], ``beta`` [H]: the
    output [H, V]."""
    state.mul_(g.exp()[..., None])
    new = v - (k[:, None] @ state)[:, 0]
    state.add_((beta[:, None] * k)[..., None] * new[:, None])
    return (q[:, None] @ state)[:, 0]


def kda_decode_step_reference(window, conv, g, gate, b, o_norm, state, rms_eps):
    """One token through a KDA layer after its projections, in plain torch
    (the kernel's twin): ``window`` [4, 3 H K] the convolutions' inputs (the
    kept 3 and this token's q, k, v), ``conv`` [4, 3 H K] float32 their
    taps, ``g`` [H, K] float32 the log-decay, ``gate`` [1, H V] the output
    gate's pre-activation, ``b`` [1, H] beta's, ``o_norm`` [V] float32 the
    RMSNorm's scale, ``state`` [H, K, V] float32, updated in place. Returns
    ``RMSNorm(o) * sigmoid(gate)`` [1, H V] in ``window``'s dtype."""
    heads, d = g.shape
    q, k, v = F.silu((window.float() * conv).sum(0)).view(3, heads, d)
    q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
    k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + L2_EPS)
    o = kda_step(state, q, k, v, g, b.float().sigmoid().view(heads))
    o = F.rms_norm(o, (d,), o_norm, rms_eps) * gate.float().view(heads, d).sigmoid()
    return o.to(window.dtype).view(1, -1)


def check_decode_operands(window, conv, g, gate, b, o_norm, state) -> None:
    """Raise ``ValueError`` on what the decode kernel does not take: other
    shapes than ``kda_decode_step_reference``'s at K = V = ``WIDTH``,
    ``window``, ``gate`` and ``b`` not bf16 or the rest not float32, an
    operand not contiguous. Needs no card."""
    heads = g.shape[0]
    ops = {"window": window, "conv": conv, "g": g, "gate": gate, "b": b, "o_norm": o_norm,
           "state": state}
    want = {"window": (torch.bfloat16, (4, 3 * heads * WIDTH)),
            "conv": (torch.float32, (4, 3 * heads * WIDTH)),
            "g": (torch.float32, (heads, WIDTH)), "gate": (torch.bfloat16, (1, heads * WIDTH)),
            "b": (torch.bfloat16, (1, heads)), "o_norm": (torch.float32, (WIDTH,)),
            "state": (torch.float32, (heads, WIDTH, WIDTH))}
    bad = {n: (t.dtype, tuple(t.shape)) for n, t in ops.items()
           if (t.dtype, tuple(t.shape)) != want[n] or not t.is_contiguous()}
    if bad:
        raise ValueError(f"the KDA decode kernel takes contiguous {want}, got {bad}")


def kda_decode_step(window, conv, g, gate, b, o_norm, state, rms_eps):
    """``kda_decode_step_reference``'s contract: on a CUDA tensor the kernel
    (``check_decode_operands``), else the twin."""
    if window.device.type != "cuda":
        return kda_decode_step_reference(window, conv, g, gate, b, o_norm, state, rms_eps)
    check_decode_operands(window, conv, g, gate, b, o_norm, state)
    heads = g.shape[0]
    out = torch.empty(1, heads * WIDTH, dtype=torch.bfloat16, device=window.device)
    with torch.cuda.device(window.device):
        err = load().rfe_kda_decode_step(
            window.data_ptr(), conv.data_ptr(), g.data_ptr(), gate.data_ptr(), b.data_ptr(),
            o_norm.data_ptr(), state.data_ptr(), out.data_ptr(), heads, L2_EPS, WIDTH ** -0.5,
            rms_eps, torch.cuda.current_stream(window.device).cuda_stream)
    if err != 0:
        raise RuntimeError("kda_decode_step kernel launch failed: "
                           + load().rfe_kda_error_string(err).decode())
    kda_decode_step.launches += 1
    return out


kda_decode_step.launches = 0
