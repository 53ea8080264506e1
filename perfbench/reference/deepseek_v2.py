"""Plain DeepSeek-V2 forward pass (the reference, written fresh).

``DeepseekV2ForCausalLM`` of the published ``modeling_deepseek.py``
(arXiv:2405.04434 §2) at inference, for one token sequence, in float32
with TF32 off, from a ``config.json`` dict and weights under the
checkpoint's names. It imports nothing but ``torch``. Departures, none of
which changes the mathematics:

- one sequence, no cache, no batching, no padding: the only mask is the
  causal one;
- the weights stay as given (bf16 in the benchmark) and each layer's are
  cast to float32 when the layer runs, so the model fits one card beside
  nothing else;
- attention runs in blocks of ``q_block`` queries, each block's softmax
  exact over the keys its queries see (the whole score matrix of a
  16k-token prompt would be 17 GB a layer);
- the rope tables stay float32 (``modeling_deepseek`` casts them to the
  model's dtype), and RMSNorm multiplies by its scale in float32;
- the routed experts' weighted sum and the shared experts are added in
  float32;
- the MoE layer loops over experts as ``moe_infer`` does, each expert's
  output added to its tokens' rows.

``precision="fp8"`` is the control, the step below the program's bf16:
each product's operands are rounded to float8 e4m3 with a scale per row
along the contraction (a row's largest magnitude at e4m3's 448), then
multiplied in float32.

``random_weights`` makes the seeded weights the benchmark and the tests
run both the program and this reference on (no trained checkpoint is in
the repository).
"""

from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0
SELF_HEAD_GAIN = 2.0


def weight_shapes(cfg: dict) -> dict:
    """Checkpoint name -> (out, in) shape of every weight of ``cfg``."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    out = {"model.embed_tokens.weight": (cfg["vocab_size"], h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (h,)
        out[p + "self_attn.q_proj.weight"] = (heads * (nope + rope), h)
        out[p + "self_attn.kv_a_proj_with_mqa.weight"] = (rank + rope, h)
        out[p + "self_attn.kv_a_layernorm.weight"] = (rank,)
        out[p + "self_attn.kv_b_proj.weight"] = (heads * (nope + vd), rank)
        out[p + "self_attn.o_proj.weight"] = (h, heads * vd)
        out[p + "post_attention_layernorm.weight"] = (h,)
        if _is_moe(cfg, i):
            out[p + "mlp.gate.weight"] = (cfg["n_routed_experts"], h)
            widths = {f"mlp.experts.{e}.": cfg["moe_intermediate_size"]
                      for e in range(cfg["n_routed_experts"])}
            if cfg["n_shared_experts"]:
                widths["mlp.shared_experts."] = cfg["moe_intermediate_size"] * cfg[
                    "n_shared_experts"]
        else:
            widths = {"mlp.": cfg["intermediate_size"]}
        for m, f in widths.items():
            out[p + m + "gate_proj.weight"] = (f, h)
            out[p + m + "up_proj.weight"] = (f, h)
            out[p + m + "down_proj.weight"] = (h, f)
    out["model.norm.weight"] = (h,)
    out["lm_head.weight"] = (cfg["vocab_size"], h)
    return out


def random_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights under the checkpoint's names, bf16 on ``device``:
    matrices normal with std 1/sqrt(fan in), the embedding normal, RMSNorm
    scales 1 + 0.02 normal. In every layer the first ``heads // 8`` heads
    (at least one) take the shared rope key's rows, times
    ``SELF_HEAD_GAIN``, as their rope query's, so they attend mostly to
    their own position, as trained models' local heads attend near
    theirs: with every row random, attention over a long prompt is near
    uniform, and no one cached row (a decode step's own) moves the
    output."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in weight_shapes(cfg).items():
        w = torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
        if len(shape) == 1:
            w = w.mul_(0.02).add_(1.0)
        elif name != "model.embed_tokens.weight":
            w = w.mul_(shape[1] ** -0.5)
        out[name] = w
    heads, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}.self_attn."
        q = out[p + "q_proj.weight"].view(heads, nope + cfg["qk_rope_head_dim"], -1)
        k_pe = out[p + "kv_a_proj_with_mqa.weight"][cfg["kv_lora_rank"]:]
        q[: max(1, heads // 8), nope:] = k_pe * SELF_HEAD_GAIN
    return out


def _is_moe(cfg: dict, i: int) -> bool:
    return (cfg["n_routed_experts"] is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def yarn_cos_sin(cfg: dict, n: int, device) -> tuple:
    """``DeepseekV2YarnRotaryEmbedding``'s tables for positions 0..n-1."""
    rs = cfg["rope_scaling"]
    dim, base, factor = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), rs["factor"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    mask = 1.0 - ramp
    inv_freq = inter * (1 - mask) + extra * mask
    freqs = torch.outer(torch.arange(n, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = yarn_get_mscale(factor, rs["mscale"]) / yarn_get_mscale(factor, rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def apply_rotary(x, cos, sin):
    """``apply_rotary_pos_emb`` for one tensor: interleaved pairs into
    halves, then ``x cos + rotate_half(x) sin``."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    return x * cos + _rotate_half(x) * sin


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class DeepseekV2Reference:
    def __init__(self, weights: dict, cfg: dict, precision: str = "float32",
                 q_block: int = 512):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.w, self.cfg, self.precision, self.q_block = weights, cfg, precision, q_block

    def _mm(self, a, b):
        """``a @ b^T``, the contraction along both operands' last dim."""
        if self.precision == "fp8":
            a, b = _fp8_rows(a), _fp8_rows(b)
        return a @ b.transpose(-1, -2)

    def _rms(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return w * (x * torch.rsqrt(var + self.cfg["rms_norm_eps"]))

    def _mlp(self, x, w, p):
        g = self._mm(x, w[p + "gate_proj.weight"])
        u = self._mm(x, w[p + "up_proj.weight"])
        return self._mm(torch.nn.functional.silu(g) * u, w[p + "down_proj.weight"])

    def _attention(self, x, w, p, cos, sin):
        cfg = self.cfg
        t, heads = x.shape[0], cfg["num_attention_heads"]
        nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        q = self._mm(x, w[p + "q_proj.weight"]).view(t, heads, nope + rope).transpose(0, 1)
        q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
        ckv = self._mm(x, w[p + "kv_a_proj_with_mqa.weight"])
        ckv, k_pe = torch.split(ckv, [cfg["kv_lora_rank"], rope], dim=-1)
        k_pe = k_pe.view(t, 1, rope).transpose(0, 1)
        kv = self._mm(self._rms(ckv, w[p + "kv_a_layernorm.weight"]), w[p + "kv_b_proj.weight"])
        kv = kv.view(t, heads, nope + vd).transpose(0, 1)
        k_nope, v = torch.split(kv, [nope, vd], dim=-1)
        q_pe, k_pe = apply_rotary(q_pe, cos, sin), apply_rotary(k_pe, cos, sin)
        q = torch.cat((q_nope, q_pe), -1)
        k = torch.cat((k_nope, k_pe.expand(heads, t, rope)), -1)
        scale = softmax_scale(cfg)
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
        scores = torch.softmax(self._mm(x, w[p + "gate.weight"]), dim=-1)
        topk_weight, topk_idx = torch.topk(scores, k=cfg["num_experts_per_tok"], dim=-1)
        if cfg["norm_topk_prob"]:
            topk_weight = topk_weight / topk_weight.sum(-1, keepdim=True)
        topk_weight = topk_weight * cfg["routed_scaling_factor"]
        y = torch.zeros_like(x)
        for e in range(cfg["n_routed_experts"]):
            tok, slot = (topk_idx == e).nonzero(as_tuple=True)
            if len(tok):
                ye = self._mlp(x[tok], w, f"{p}experts.{e}.")
                y.index_add_(0, tok, ye * topk_weight[tok, slot, None])
        if cfg["n_shared_experts"]:
            y = y + self._mlp(x, w, p + "shared_experts.")
        return y

    @torch.no_grad()
    def logits(self, ids, last: int = 1) -> torch.Tensor:
        """Float32 logits ``[last, vocab]`` of the last ``last`` positions of
        one forward pass over ``ids``."""
        cfg, w = self.cfg, self.w
        dev = w["model.embed_tokens.weight"].device
        with _no_tf32():
            ids = torch.as_tensor(ids, device=dev)
            x = w["model.embed_tokens.weight"][ids].float()
            cos, sin = yarn_cos_sin(cfg, len(ids), dev)
            for i in range(cfg["num_hidden_layers"]):
                p = f"model.layers.{i}."
                lw = {k: v.float() for k, v in w.items() if k.startswith(p)}
                x = x + self._attention(self._rms(x, lw[p + "input_layernorm.weight"]), lw,
                                        p + "self_attn.", cos, sin)
                h = self._rms(x, lw[p + "post_attention_layernorm.weight"])
                x = x + (self._moe(h, lw, p + "mlp.") if _is_moe(cfg, i)
                         else self._mlp(h, lw, p + "mlp."))
                del lw
            x = self._rms(x[-last:], w["model.norm.weight"].float())
            return self._mm(x, w["lm_head.weight"].float())
