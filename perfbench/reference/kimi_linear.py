"""Plain Kimi-Linear forward pass (the reference, written fresh).

``KimiLinearForCausalLM`` of the published ``modeling_kimi.py`` with
flash-linear-attention's ``KimiDeltaAttention`` (the Kimi Linear report,
arXiv:2510.26692) at inference, for one token sequence, in float32 with
TF32 off, from a ``config.json`` dict and weights under the checkpoint's
names. It imports nothing but ``torch`` and the DeepSeek-V2 reference's
fp8 rounding and TF32 switch. Per layer:

- KDA (the layers of ``linear_attn_config["kda_layers"]``, 1-based): q, k
  and v each ``W x``, a causal depthwise convolution of width 4 over the
  sequence (zeros before its start), SiLU; ``q / |q| * d^-1/2`` and ``k /
  |k|`` (``|x| = sqrt(sum x^2 + 1e-6)``); ``g = -exp(A_log[h]) *
  softplus(W_fb W_fa x + dt_bias)`` per key channel; ``beta = sigmoid(W_b
  x)``; the state ``S <- Diag(exp g) S; S <- S + beta k (v - S^T k)^T``,
  ``o = S^T q`` (``kda_recurrent``); ``W_o [RMSNorm(o) * sigmoid(W_gb W_ga
  x)]``, the norm per head over its 128 values.
- MLA (``full_attn_layers``), NoPE: DeepSeek-V2's latent attention with
  q_pe and k_pe unrotated, scores times ``(nope + rope)^-1/2``.
- Layer 0 a dense SwiGLU; the others a MoE: sigmoid scores over all
  routed experts, the top ``num_experts_per_token`` on the scores plus
  ``e_score_correction_bias``, the chosen scores renormalised (plus 1e-20)
  and times ``routed_scaling_factor``, the held experts' SwiGLUs (``w1``
  gate, ``w3`` up, ``w2`` down) and the shared expert.

The expert share: ``num_experts`` counts the experts held, ``expert_parallel``
the cards that share a layer (the router has ``num_experts *
expert_parallel`` outputs), ``expert_rank`` which share this is. Pairs
routed to experts held elsewhere add nothing, as in the program.

Departures, none of which changes the mathematics:

- one sequence, no cache, no batching, no padding;
- each layer's weights are cast to float32 when the layer runs;
- the MLA layers run in blocks of ``q_block`` queries, each block's
  softmax exact over the keys its queries see;
- KDA is evaluated in the exact chunked form (``kda_chunked``, chunks of
  ``chunk`` rows; the program's are 64): within a chunk the decays
  ``exp(G_t - G_s)``, ``G`` the running sum of ``g``, are taken element by
  element (each at most 1), the chunk's pseudo-values ``U`` solve ``(I +
  A) U = beta (v - (k e^G) S)`` from the state it starts with, then ``O =
  (q e^G) S + P U`` and ``S <- e^{G_C} S + (k e^{G_C - G})^T U``. A CPU test
  ties it to ``kda_recurrent``;
- the MoE layer loops over the held experts, each one's output added to
  its tokens' rows.

``precision="fp8"`` is the control, the step below the program's bf16: each
weight product's and attention product's operands rounded to float8 e4m3
with a scale per row along the contraction, then multiplied in float32.

``random_weights`` makes the seeded weights the benchmark and the tests run
both the program and this reference on: a mapping that makes each weight
from the seed and its name when it is read (the same weight whatever else
is read, or in what order), so neither side ever holds the whole model
twice. The residual branches' output projections are scaled by 1/sqrt(2 x
layers), GPT-2's initialisation: unscaled, each MoE layer's branch (8
experts weighted 2.446 in all) is as large as the stream, and every
near-tie of the router that rounding flips moves the next layers'
routing: at the CPU test's widths a bf16 program then read a median
relative logit error of 0.27-0.32 against this reference, near the fp8
control's 0.63-0.73; scaled, 0.005-0.007 against the control's 0.07-0.08. KDA's decays are drawn as Mamba-2 initialises them (``A`` uniform in
[1, 16], ``dt`` log-uniform in [1e-4, 1e-1], ``dt_bias`` its inverse
softplus) and ``W_fb`` is scaled by ``DECAY_NOISE``, so channels keep
their memory from a fraction of a token to ~7,000 tokens: fully random
decay weights make ``exp g`` about 0, and a state never carried would
still pass.
"""

from __future__ import annotations

import hashlib
import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from .deepseek_v2 import SELF_HEAD_GAIN, _fp8_rows, _no_tf32

L2_EPS = 1e-6
DT_RANGE = (1e-4, 1e-1)
A_RANGE = (1.0, 16.0)
DECAY_NOISE = 0.5  # W_fb's scale: the decay's spread around dt_bias
CONV_STD = 0.5  # 1 / sqrt(the convolution's width)
# the residual branches' output projections, times 1 / sqrt(2 x layers) as
# GPT-2 initialises them
BRANCH_OUT = ("o_proj.weight", "down_proj.weight", "w2.weight")
BIAS_STD = 0.02  # the router's correction bias


def _lin(cfg: dict) -> dict:
    return cfg["linear_attn_config"]


def is_kda(cfg: dict, i: int) -> bool:
    return i + 1 in _lin(cfg)["kda_layers"]


def is_moe(cfg: dict, i: int) -> bool:
    return bool(cfg["num_experts"]) and i >= cfg["first_k_dense_replace"] and i % cfg.get(
        "moe_layer_freq", 1) == 0


def experts(cfg: dict) -> tuple:
    """(routed experts, first held, experts held)."""
    held = cfg["num_experts"]
    return held * cfg.get("expert_parallel", 1), held * cfg.get("expert_rank", 0), held


def weight_shapes(cfg: dict) -> dict:
    """Checkpoint name -> shape of every weight this share holds."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    kh, d, width = _lin(cfg)["num_heads"], _lin(cfg)["head_dim"], _lin(cfg)["short_conv_kernel_size"]
    routed, first, held = experts(cfg)
    out = {"model.embed_tokens.weight": (cfg["vocab_size"], h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out[p + "input_layernorm.weight"] = (h,)
        out[p + "post_attention_layernorm.weight"] = (h,)
        if is_kda(cfg, i):
            for x in "qkv":
                out[a + f"{x}_proj.weight"] = (kh * d, h)
                out[a + f"{x}_conv1d.weight"] = (kh * d, 1, width)
            out[a + "A_log"] = (1, 1, kh, 1)
            out[a + "dt_bias"] = (kh * d,)
            out[a + "f_a_proj.weight"] = (d, h)
            out[a + "f_b_proj.weight"] = (kh * d, d)
            out[a + "b_proj.weight"] = (kh, h)
            out[a + "g_a_proj.weight"] = (d, h)
            out[a + "g_b_proj.weight"] = (kh * d, d)
            out[a + "o_norm.weight"] = (d,)
            out[a + "o_proj.weight"] = (h, kh * d)
        else:
            out[a + "q_proj.weight"] = (heads * (nope + rope), h)
            out[a + "kv_a_proj_with_mqa.weight"] = (rank + rope, h)
            out[a + "kv_a_layernorm.weight"] = (rank,)
            out[a + "kv_b_proj.weight"] = (heads * (nope + vd), rank)
            out[a + "o_proj.weight"] = (h, heads * vd)
        if is_moe(cfg, i):
            m, f = p + "block_sparse_moe.", cfg["moe_intermediate_size"]
            out[m + "gate.weight"] = (routed, h)
            out[m + "gate.e_score_correction_bias"] = (routed,)
            for e in range(first, first + held):
                out[f"{m}experts.{e}.w1.weight"] = (f, h)
                out[f"{m}experts.{e}.w3.weight"] = (f, h)
                out[f"{m}experts.{e}.w2.weight"] = (h, f)
            widths = {m + "shared_experts.": f * cfg["num_shared_experts"]} if cfg.get(
                "num_shared_experts") else {}
        else:
            widths = {p + "mlp.": cfg["intermediate_size"]}
        for m, f in widths.items():
            out[m + "gate_proj.weight"] = (f, h)
            out[m + "up_proj.weight"] = (f, h)
            out[m + "down_proj.weight"] = (h, f)
    out["model.norm.weight"] = (cfg["hidden_size"],)
    out["lm_head.weight"] = (cfg["vocab_size"], h)
    return out


def _subseed(seed: int, name: str) -> int:
    return int.from_bytes(hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest(),
                          "little") >> 1


class SeededWeights(Mapping):
    """Every weight under its checkpoint name, bf16 on ``device``, made from
    ``(seed, name)`` when read: matrices normal with std 1/sqrt(fan in),
    the residual branches' output projections (attention's and KDA's
    ``o_proj``, every SwiGLU's down projection) further times 1/sqrt(2 x
    layers) as GPT-2 initialises them, the embedding normal, RMSNorm scales 1 + 0.02 normal, the convolutions
    normal times ``CONV_STD``, the router's bias normal times ``BIAS_STD``,
    KDA's decay as the module docstring says. In each MLA layer the first
    ``heads // 8`` heads (at least one) take the shared key's rows, times
    ``SELF_HEAD_GAIN``, as their q_pe rows, so they attend mostly to their
    own position: with every row random, attention over a long prompt is
    near uniform, and no one cached row moves the output."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.shapes = weight_shapes(cfg)

    def __len__(self):
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def _randn(self, name: str, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(_subseed(self.seed, name))
        return torch.randn(shape, generator=g, device=self.device, dtype=torch.float32)

    def __getitem__(self, name: str) -> torch.Tensor:
        shape = self.shapes[name]
        if name.endswith("A_log"):
            u = self._randn(name, shape).mul_(0.5 ** 0.5).erf_().add_(1).mul_(0.5)  # uniform
            w = (A_RANGE[0] + u * (A_RANGE[1] - A_RANGE[0])).log()
        elif name.endswith("dt_bias"):
            u = self._randn(name, shape).mul_(0.5 ** 0.5).erf_().add_(1).mul_(0.5)
            lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
            dt = (lo + u * (hi - lo)).exp()
            w = dt + torch.log(-torch.expm1(-dt))  # softplus(w) = dt
        elif name.endswith("e_score_correction_bias"):
            w = self._randn(name, shape).mul_(BIAS_STD)
        elif len(shape) == 1:
            w = self._randn(name, shape).mul_(0.02).add_(1.0)
        elif name.endswith("conv1d.weight"):
            w = self._randn(name, shape).mul_(CONV_STD)
        elif name == "model.embed_tokens.weight":
            w = self._randn(name, shape)
        else:
            w = self._randn(name, shape).mul_(shape[1] ** -0.5)
            if name.endswith(BRANCH_OUT):
                w.mul_((2 * self.cfg["num_hidden_layers"]) ** -0.5)
            elif name.endswith("f_b_proj.weight"):
                w.mul_(DECAY_NOISE)
            elif name.endswith("q_proj.weight") and name.replace(
                    "q_proj", "kv_a_proj_with_mqa") in self.shapes:  # an MLA layer's
                cfg = self.cfg
                heads, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
                q = w.view(heads, nope + cfg["qk_rope_head_dim"], -1)
                k_pe = self[name.replace("q_proj", "kv_a_proj_with_mqa")][cfg["kv_lora_rank"]:]
                q[: max(1, heads // 8), nope:] = k_pe.float() * SELF_HEAD_GAIN
        return w.to(torch.bfloat16)


def random_weights(cfg: dict, seed: int, device) -> SeededWeights:
    return SeededWeights(cfg, seed, device)


def kda_recurrent(q, k, v, g, beta, state=None):
    """The recurrence token by token: ``q``, ``k``, ``g`` [n, H, K], ``v``
    [n, H, V], ``beta`` [n, H]; the outputs [n, H, V] and the last state."""
    n, heads, dk = q.shape
    s = q.new_zeros(heads, dk, v.shape[-1]) if state is None else state.clone()
    out = []
    for t in range(n):
        s = s * g[t].exp()[..., None]
        s = s + (beta[t][:, None] * k[t])[..., None] * (v[t] - (k[t][..., None] * s).sum(-2))[:, None]
        out.append((q[t][..., None] * s).sum(-2))
    return torch.stack(out), s


def kda_chunked(q, k, v, g, beta, chunk: int = 32, group: int = 32):
    """``kda_recurrent`` in the exact chunked form (module docstring), from a
    zero state; ``group`` chunks' intra-chunk decays at once."""
    n, heads, dk = q.shape
    nc = -(-n // chunk)

    def blocks(x):
        out = x.new_zeros(nc * chunk, *x.shape[1:])
        out[:n] = x
        return out.view(nc, chunk, heads, -1).transpose(1, 2)  # [NC, H, C, D]

    q, k, v, g, beta = blocks(q), blocks(k), blocks(v), blocks(g), blocks(beta[..., None])
    G = g.cumsum(2)
    t = torch.arange(chunk, device=q.device)
    after = t[None, :] > t[:, None]  # s > t
    s = q.new_zeros(heads, dk, v.shape[-1])
    out = torch.empty_like(v)
    for a in range(0, nc, group):
        cs = slice(a, min(nc, a + group))
        diff = G[cs, :, :, None, :] - G[cs, :, None, :, :]  # [c, H, t, s, K]
        dec = diff.masked_fill_(after[:, :, None], float("-inf")).exp_()
        p = (q[cs, :, :, None, :] * k[cs, :, None, :, :] * dec).sum(-1)
        am = (k[cs, :, :, None, :] * k[cs, :, None, :, :] * dec).sum(-1)
        am = am.tril(-1) * beta[cs]
        del dec, diff
        for j in range(cs.start, cs.stop):
            jj = j - cs.start
            eg = G[j].exp()
            u = torch.linalg.solve_triangular(
                am[jj], beta[j] * (v[j] - (k[j] * eg) @ s), upper=False, unitriangular=True)
            out[j] = (q[j] * eg) @ s + p[jj] @ u
            last = G[j, :, -1:]
            s = last.transpose(1, 2).exp() * s + (k[j] * torch.exp(last - G[j])).transpose(1, 2) @ u
    return out.transpose(1, 2).reshape(nc * chunk, heads, -1)[:n], s


class KimiLinearReference:
    def __init__(self, weights, cfg: dict, precision: str = "float32", q_block: int = 512,
                 chunk: int = 32):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.w, self.cfg, self.precision = weights, cfg, precision
        self.q_block, self.chunk = q_block, chunk

    def _mm(self, a, b):
        """``a @ b^T``, the contraction along both operands' last dim."""
        if self.precision == "fp8":
            a, b = _fp8_rows(a), _fp8_rows(b)
        return a @ b.transpose(-1, -2)

    def _rms(self, x, w):
        return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.cfg["rms_norm_eps"]))

    def _mlp(self, x, w, p, gate="gate_proj", up="up_proj", down="down_proj"):
        return self._mm(F.silu(self._mm(x, w[f"{p}{gate}.weight"])) * self._mm(x, w[f"{p}{up}.weight"]),
                        w[f"{p}{down}.weight"])

    def _kda(self, x, w, p):
        lin = _lin(self.cfg)
        n, heads, d, width = x.shape[0], lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]

        def conv(name):
            y = self._mm(x, w[p + f"{name}_proj.weight"])
            cw = w[p + f"{name}_conv1d.weight"][:, 0]
            yp = torch.cat((y.new_zeros(width - 1, y.shape[1]), y))
            return F.silu(sum(yp[j:j + n] * cw[:, j] for j in range(width))).view(n, heads, d)

        def l2(z):
            return z * torch.rsqrt(z.pow(2).sum(-1, keepdim=True) + L2_EPS)

        q, k, v = l2(conv("q")) * d ** -0.5, l2(conv("k")), conv("v")
        f = self._mm(self._mm(x, w[p + "f_a_proj.weight"]), w[p + "f_b_proj.weight"])
        g = -w[p + "A_log"].view(heads, 1).exp() * F.softplus(
            f.view(n, heads, d) + w[p + "dt_bias"].view(heads, d))
        beta = torch.sigmoid(self._mm(x, w[p + "b_proj.weight"]))
        o, _ = kda_chunked(q, k, v, g, beta, self.chunk)
        gate = self._mm(self._mm(x, w[p + "g_a_proj.weight"]), w[p + "g_b_proj.weight"])
        o = self._rms(o, w[p + "o_norm.weight"]) * torch.sigmoid(gate.view(n, heads, d))
        return self._mm(o.reshape(n, heads * d), w[p + "o_proj.weight"])

    def _mla(self, x, w, p):
        cfg = self.cfg
        t, heads = x.shape[0], cfg["num_attention_heads"]
        nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        q = self._mm(x, w[p + "q_proj.weight"]).view(t, heads, nope + rope).transpose(0, 1)
        ckv, k_pe = self._mm(x, w[p + "kv_a_proj_with_mqa.weight"]).split(
            [cfg["kv_lora_rank"], rope], -1)
        kv = self._mm(self._rms(ckv, w[p + "kv_a_layernorm.weight"]), w[p + "kv_b_proj.weight"])
        k_nope, v = kv.view(t, heads, nope + vd).transpose(0, 1).split([nope, vd], -1)
        k = torch.cat((k_nope, k_pe[None].expand(heads, t, rope)), -1)
        scale = (nope + rope) ** -0.5
        out = torch.empty(heads, t, vd, device=x.device)
        for a in range(0, t, self.q_block):
            b = min(t, a + self.q_block)
            s = self._mm(q[:, a:b], k[:, :b]) * scale
            causal = torch.arange(b, device=x.device)[None] > torch.arange(a, b, device=x.device)[:, None]
            s = s.masked_fill(causal, float("-inf"))
            out[:, a:b] = self._mm(torch.softmax(s, dim=-1), v[:, :b].transpose(-1, -2))
        return self._mm(out.transpose(0, 1).reshape(t, heads * vd), w[p + "o_proj.weight"])

    def _moe(self, x, w, p):
        cfg = self.cfg
        routed, first, held = experts(cfg)
        scores = torch.sigmoid(self._mm(x, w[p + "gate.weight"]))
        idx = torch.topk(scores + w[p + "gate.e_score_correction_bias"],
                         k=cfg["num_experts_per_token"], dim=-1).indices
        weight = scores.gather(1, idx)
        if cfg.get("moe_renormalize", True):
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        weight = weight * cfg["routed_scaling_factor"]
        y = torch.zeros_like(x)
        for e in range(first, first + held):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if len(tok):
                ye = self._mlp(x[tok], w, f"{p}experts.{e}.", "w1", "w3", "w2")
                y.index_add_(0, tok, ye * weight[tok, slot, None])
        if cfg.get("num_shared_experts"):
            y = y + self._mlp(x, w, p + "shared_experts.")
        return y

    def layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` of the float32 residual stream ``x`` [n, hidden]."""
        cfg, p = self.cfg, f"model.layers.{i}."
        lw = {k: self.w[k].float() for k in self.w if k.startswith(p)}
        h = self._rms(x, lw[p + "input_layernorm.weight"])
        mix = self._kda if is_kda(cfg, i) else self._mla
        x = x + mix(h, lw, p + "self_attn.")
        h = self._rms(x, lw[p + "post_attention_layernorm.weight"])
        return x + (self._moe(h, lw, p + "block_sparse_moe.") if is_moe(cfg, i)
                    else self._mlp(h, lw, p + "mlp."))

    @torch.no_grad()
    def logits(self, ids, last: int = 1) -> torch.Tensor:
        """Float32 logits ``[last, vocab]`` of the last ``last`` positions of
        one forward pass over ``ids``."""
        cfg, w = self.cfg, self.w
        emb = w["model.embed_tokens.weight"]
        with _no_tf32():
            x = emb[torch.as_tensor(ids, device=emb.device)].float()
            del emb
            for i in range(cfg["num_hidden_layers"]):
                x = self.layer(i, x)
            x = self._rms(x[-last:], w["model.norm.weight"].float())
            return self._mm(x, w["lm_head.weight"].float())
