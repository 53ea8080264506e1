"""Kimi-Linear (Kimi Delta Attention beside latent attention, sigmoid-routed
MoE), the native answer generator's second model.

The layer equations of the Kimi Linear report (arXiv:2510.26692) and of
its published ``modeling_kimi.py`` with flash-linear-attention's
``KimiDeltaAttention`` (``fla/layers/kda.py``, ``fla/ops/kda``), at the
widths a Kimi-Linear ``config.json`` gives (``KimiLinearConfig.from_hf``);
the defaults are Kimi-Linear-48B-A3B's: 27 layers, hidden 2,304, vocabulary
163,840, untied head. The 1-based ``linear_attn_config`` lists put KDA at
20 layers and MLA at 0-based 3, 7, 11, 15, 19, 23, 26.

- KDA (per head h, d_k = d_v = 128): ``q, k, v = SiLU(conv4(W x))``, three
  causal depthwise convolutions of width 4 (each one's state its last 3
  inputs); ``q^ = q / |q| * 128^-1/2``, ``k^ = k / |k|`` (l2 norm with eps
  1e-6 inside the root, fla's ``l2norm``); the log-decay of each key
  channel ``g = -exp(A_log[h]) * softplus(W_fb W_fa x + dt_bias)``;
  ``beta = sigmoid(W_b x)[h]``; the state ``S <- Diag(exp g) S``, then
  ``S <- S + beta k^ (v - S^T k^)^T``; ``o = S^T q^``; the layer's output
  ``W_o [RMSNorm_head(o) * sigmoid(W_gb W_ga x)]`` (one RMSNorm scale of 128
  shared by the heads, eps ``rms_norm_eps``). ``ops/kda.py`` computes the
  recurrence: a prefill in its exact chunked form (chunks of 64, the
  chunk-to-chunk state pass a kernel of ``csrc/kda_state_pass.cu``), a
  decode step token by token (all but the projections the file's second
  kernel).
- MLA at the 7 full-attention layers: DeepSeek-V2's (``models/deepseek_v2``:
  the latent cache, ``_latent``, the prefill kernel, the absorbed decode)
  with NoPE (``mla_use_nope``): q_pe and k_pe are used unrotated; scores
  ``(q_nope k_nope + q_pe k_pe) * 192^-1/2``; 32 heads.
- Layer 0 holds a dense SwiGLU (``intermediate_size``); the others a MoE:
  a float32 router to all ``n_routed_experts`` experts with sigmoid
  scores; the top ``num_experts_per_tok`` chosen on the scores plus the
  gate's ``e_score_correction_bias`` (DeepSeek-V3's rule; one group, so
  ``use_grouped_topk`` with ``num_expert_group`` 1 is the plain top-k);
  the chosen experts weighted by their unbiased scores, renormalised over
  the chosen (``moe_renormalize``, plus 1e-20) and times
  ``routed_scaling_factor``; and one shared expert every token passes.
- Pre-norm residual blocks, RMSNorm (eps ``rms_norm_eps``), final norm,
  ``lm_head``.

Expert parallelism. ``num_experts`` of a configuration file counts the
experts this card holds and ``expert_parallel`` the cards that share each
MoE layer's experts, so the router has ``num_experts * expert_parallel``
outputs; ``expert_rank`` (default 0) places this card's experts (card r
holds ``r * held .. (r + 1) * held - 1``). Each MoE layer routes over all
of them and computes the part its held experts give, plus the shared
expert (what every card computes alike): the partial sum goes on to the
next layer, and pairs routed elsewhere add nothing here.

Caches: the 7 MLA layers keep DeepSeek-V2's latent rows (576 values a
position, grown with the prompt); each KDA layer a float32 state [32, 128,
128] and its three convolutions' last 3 inputs, both fixed buffers that a
prefill fills and the captured decode graph updates in place.

Assumed where neither the report nor the configuration fixes it (the
configuration file's ``assumed`` lists the same): the checkpoint names
(``self_attn.{q,k,v}_proj``, ``{q,k,v}_conv1d`` [D, 1, 4], ``A_log`` [1, 1,
H, 1], ``f_a_proj`` / ``f_b_proj``, ``dt_bias`` [H * 128], ``b_proj``,
``g_a_proj`` / ``g_b_proj``, ``o_norm``, ``o_proj``; the MoE under
``block_sparse_moe`` with ``gate.weight``, ``gate.e_score_correction_bias``,
``experts.{e}.w1`` (gate) / ``w3`` (up) / ``w2`` (down) and
``shared_experts``); no projection, convolution or gate carries a bias;
the output gate is ``sigmoid``.

Precision "bfloat16": weights and products in bf16 with float32
accumulation; the residual stream, every RMSNorm, the router and its
top-k, KDA's convolution sums, decay, running sums and exponentials,
``beta``, the l2 norms and the KDA state in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.kda import CHUNK, L2_EPS, kda_chunked, kda_decode_step, kda_state_pass, to_blocks
from .deepseek_v2 import DeepseekV2, _Layer, _routed, _swiglu



@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kda_layers: tuple = (0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 16, 17, 18, 20, 21, 22, 24, 25)
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4
    n_routed_experts: int = 256  # the router's outputs
    experts_held: int = 256  # experts this card computes
    first_expert: int = 0
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 1048576
    dtype: str = "bfloat16"  # "bfloat16" or "float32"

    @classmethod
    def from_hf(cls, hf: dict) -> "KimiLinearConfig":
        """From a published ``config.json`` (plus ``expert_parallel`` and
        ``expert_rank`` where a card holds a share of the experts), in its
        ``torch_dtype`` (bf16 where it names none). The 1-based
        ``linear_attn_config`` lists become 0-based; ``model_max_length`` is
        the position limit. What this module does not compute (q-LoRA, a
        rotary MLA, another router activation, grouped routing over several
        groups, MTP layers, tied embeddings, other dtypes) raises."""
        dtype = hf.get("torch_dtype", "bfloat16")
        lin = hf["linear_attn_config"]
        kda = sorted(i - 1 for i in lin["kda_layers"])
        full = sorted(i - 1 for i in lin["full_attn_layers"])
        layers = hf["num_hidden_layers"]
        unsupported = {
            "q_lora_rank": hf.get("q_lora_rank") is not None,
            "mla_use_nope": not hf.get("mla_use_nope", False),
            "moe_router_activation_func": hf.get("moe_router_activation_func") != "sigmoid",
            "num_expert_group": hf.get("num_expert_group", 1) not in (1, None),
            "num_nextn_predict_layers": bool(hf.get("num_nextn_predict_layers", 0)),
            "num_key_value_heads": hf.get("num_key_value_heads",
                                          hf["num_attention_heads"]) != hf["num_attention_heads"],
            "hidden_act": hf.get("hidden_act", "silu") != "silu",
            "tie_word_embeddings": bool(hf.get("tie_word_embeddings", False)),
            "torch_dtype": dtype not in ("bfloat16", "float32"),
            "linear_attn_config": sorted(kda + full) != list(range(layers)),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"Kimi-Linear settings not supported: {', '.join(bad)}")
        held = hf["num_experts"]
        return cls(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"], num_hidden_layers=layers,
            num_attention_heads=hf["num_attention_heads"], kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"], qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"], kda_layers=tuple(kda), kda_heads=lin["num_heads"],
            kda_head_dim=lin["head_dim"], conv_size=lin["short_conv_kernel_size"],
            n_routed_experts=held * hf.get("expert_parallel", 1), experts_held=held,
            first_expert=held * hf.get("expert_rank", 0),
            n_shared_experts=hf.get("num_shared_experts") or 0,
            num_experts_per_tok=hf["num_experts_per_token"],
            first_k_dense_replace=hf["first_k_dense_replace"],
            moe_layer_freq=hf.get("moe_layer_freq", 1),
            norm_topk_prob=bool(hf.get("moe_renormalize", True)),
            routed_scaling_factor=float(hf["routed_scaling_factor"]),
            rms_norm_eps=hf["rms_norm_eps"], max_position_embeddings=hf["model_max_length"],
            dtype=dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        """Values an MLA layer keeps a position: the latent row and the key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim ** -0.5

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    @property
    def mla_layers(self) -> tuple:
        return tuple(i for i in range(self.num_hidden_layers) if i not in self.kda_layers)

    def is_kda(self, layer: int) -> bool:
        return layer in self.kda_layers

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


def param_shapes(cfg: KimiLinearConfig) -> Dict[str, tuple]:
    """Name -> shape of every weight this card holds (the held experts'
    under their global ids), in ``torch.nn.Linear``'s (out, in) layout."""
    h, heads, d = cfg.hidden_size, cfg.num_attention_heads, cfg.kda_head_dim
    hk, kh = cfg.kda_width, cfg.kda_heads
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        p, a = f"model.layers.{i}.", f"model.layers.{i}.self_attn."
        shapes[p + "input_layernorm.weight"] = (h,)
        shapes[p + "post_attention_layernorm.weight"] = (h,)
        if cfg.is_kda(i):
            for x in "qkv":
                shapes[a + f"{x}_proj.weight"] = (hk, h)
                shapes[a + f"{x}_conv1d.weight"] = (hk, 1, cfg.conv_size)
            shapes.update({
                a + "A_log": (1, 1, kh, 1), a + "dt_bias": (hk,),
                a + "f_a_proj.weight": (d, h), a + "f_b_proj.weight": (hk, d),
                a + "b_proj.weight": (kh, h),
                a + "g_a_proj.weight": (d, h), a + "g_b_proj.weight": (hk, d),
                a + "o_norm.weight": (d,), a + "o_proj.weight": (h, hk)})
        else:
            shapes.update({
                a + "q_proj.weight": (heads * cfg.qk_head_dim, h),
                a + "kv_a_proj_with_mqa.weight": (cfg.cache_width, h),
                a + "kv_a_layernorm.weight": (cfg.kv_lora_rank,),
                a + "kv_b_proj.weight": (heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                         cfg.kv_lora_rank),
                a + "o_proj.weight": (h, heads * cfg.v_head_dim)})
        if cfg.is_moe(i):
            m, f = p + "block_sparse_moe.", cfg.moe_intermediate_size
            shapes[m + "gate.weight"] = (cfg.n_routed_experts, h)
            shapes[m + "gate.e_score_correction_bias"] = (cfg.n_routed_experts,)
            for e in range(cfg.first_expert, cfg.first_expert + cfg.experts_held):
                shapes.update({f"{m}experts.{e}.w1.weight": (f, h),
                               f"{m}experts.{e}.w3.weight": (f, h),
                               f"{m}experts.{e}.w2.weight": (h, f)})
            mlps = [(m + "shared_experts.", f * cfg.n_shared_experts)] if cfg.n_shared_experts else []
        else:
            mlps = [(p + "mlp.", cfg.intermediate_size)]
        for prefix, f in mlps:
            shapes.update({prefix + "gate_proj.weight": (f, h), prefix + "up_proj.weight": (f, h),
                           prefix + "down_proj.weight": (h, f)})
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return shapes


@dataclasses.dataclass
class _KdaLayer:
    """One KDA layer's weights as the program holds them: ``proj`` the
    q, k, v, f_a, g_a and b projections stacked by rows (one product); the
    three convolutions' taps stacked [width, 3 D] and the decay's ``-exp(A_log)``
    [heads] and ``dt_bias`` [heads, 128] in float32; the MLP or MoE as
    ``_Layer`` holds it."""
    norm_in: torch.Tensor
    norm_post: torch.Tensor
    proj: torch.Tensor
    conv: torch.Tensor
    a_neg: torch.Tensor
    dt_bias: torch.Tensor
    f_b: torch.Tensor
    g_b: torch.Tensor
    o_norm: torch.Tensor
    o: torch.Tensor
    gate_up: Optional[torch.Tensor] = None
    down: Optional[torch.Tensor] = None
    router: Optional[torch.Tensor] = None
    experts_gate_up: Optional[torch.Tensor] = None
    experts_down: Optional[torch.Tensor] = None


class KimiLinear(DeepseekV2):
    """The model on one device, with its caches, behind ``DeepseekV2``'s
    calls (``reserve``, ``prefill``, ``decode``, the CUDA graph of a decode
    step), whose MLA, grouped-expert and block code it runs. Weights come
    from ``load_state_dict`` (checkpoint names), read one at a time and
    copied into the program's layout, the routed experts layer by layer,
    so a source that makes each weight on demand is never held whole
    beside the program's copy."""

    def __init__(self, cfg: KimiLinearConfig, device):
        super().__init__(cfg, device)
        self._mla_slot = {i: j for j, i in enumerate(cfg.mla_layers)}
        self._kda_slot = {i: j for j, i in enumerate(cfg.kda_layers)}
        self._score_bias: Dict[int, torch.Tensor] = {}
        self._kda_state: Optional[torch.Tensor] = None  # [kda layers, heads, 128, 128] float32
        self._conv_tail: Optional[torch.Tensor] = None  # [kda layers, width - 1, 3 D]
        self.kda_launches = 0  # the state pass's launches, in the last prefill
        self._decode_counts: Optional[torch.Tensor] = None  # held experts' pairs since the prefill

    # --------------------------------------------------------- weights
    @torch.no_grad()
    def load_state_dict(self, sd) -> None:
        cfg = self.cfg
        shapes = param_shapes(cfg)
        missing = sorted(set(shapes) - set(sd.keys()))
        extra = sorted(set(sd.keys()) - set(shapes))
        if missing or extra:
            raise KeyError(f"state dict: missing {missing[:4]}, unexpected {extra[:4]}")

        def w(name, dtype=self.dtype):
            t = sd[name]
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
            return t.to(self.device, dtype)

        def rows(*names):
            return torch.cat([w(n) for n in names])

        self.layers, self._step, self._score_bias = [], None, {}
        self.embed = None
        for i in range(cfg.num_hidden_layers):
            p, a = f"model.layers.{i}.", f"model.layers.{i}.self_attn."
            norms = {"norm_in": w(p + "input_layernorm.weight", torch.float32),
                     "norm_post": w(p + "post_attention_layernorm.weight", torch.float32)}
            if cfg.is_kda(i):
                layer = _KdaLayer(
                    **norms,
                    proj=rows(*(a + f"{x}_proj.weight" for x in ("q", "k", "v", "f_a", "g_a", "b"))),
                    conv=torch.cat([w(a + f"{x}_conv1d.weight", torch.float32)[:, 0]
                                    for x in "qkv"]).t().contiguous(),
                    a_neg=-w(a + "A_log", torch.float32).view(-1).exp(),
                    dt_bias=w(a + "dt_bias", torch.float32).view(cfg.kda_heads, -1),
                    f_b=w(a + "f_b_proj.weight"), g_b=w(a + "g_b_proj.weight"),
                    o_norm=w(a + "o_norm.weight", torch.float32), o=w(a + "o_proj.weight"))
            else:
                layer = _Layer(
                    **norms,
                    qkv_a=self._stack_qkv_a(w(a + "q_proj.weight"), w(a + "kv_a_proj_with_mqa.weight")),
                    kv_norm=w(a + "kv_a_layernorm.weight", torch.float32),
                    kv_b=w(a + "kv_b_proj.weight"), o=w(a + "o_proj.weight"),
                    gate_up=None, down=None)
                w_ukv = layer.kv_b.view(cfg.num_attention_heads, -1, cfg.kv_lora_rank)
                layer.w_uk = w_ukv[:, : cfg.qk_nope_head_dim]
                layer.w_uv_t = w_ukv[:, cfg.qk_nope_head_dim:].transpose(1, 2)
            mlp = p + "block_sparse_moe.shared_experts." if cfg.is_moe(i) else p + "mlp."
            if not cfg.is_moe(i) or cfg.n_shared_experts:
                layer.gate_up = rows(mlp + "gate_proj.weight", mlp + "up_proj.weight")
                layer.down = w(mlp + "down_proj.weight")
            if cfg.is_moe(i):
                m = p + "block_sparse_moe."
                held = range(cfg.first_expert, cfg.first_expert + cfg.experts_held)
                layer.router = w(m + "gate.weight", torch.float32)
                self._score_bias[i] = w(m + "gate.e_score_correction_bias", torch.float32)
                layer.experts_gate_up = torch.stack([rows(f"{m}experts.{e}.w1.weight",
                                                          f"{m}experts.{e}.w3.weight")
                                                     for e in held])
                layer.experts_down = torch.stack([w(f"{m}experts.{e}.w2.weight") for e in held])
            self.layers.append(layer)
        n_kda = len(cfg.kda_layers)
        d = cfg.kda_head_dim
        self._kda_state = torch.zeros(n_kda, cfg.kda_heads, d, d, device=self.device)
        self._conv_tail = torch.zeros(n_kda, cfg.conv_size - 1, 3 * cfg.kda_width,
                                      device=self.device, dtype=self.dtype)
        self._expert_counts = torch.zeros(cfg.experts_held, dtype=torch.long, device=self.device)
        self._decode_counts = torch.zeros_like(self._expert_counts)
        self.norm = w("model.norm.weight", torch.float32)
        self.head = w("lm_head.weight")
        self.embed = w("model.embed_tokens.weight")

    # ----------------------------------------------------------- caches
    def _cached_layers(self) -> int:
        return len(self.cfg.mla_layers)

    def _rope_table(self, positions: int) -> None:
        return None  # NoPE

    def _cache_of(self, i: int) -> torch.Tensor:
        return self.cache[self._mla_slot[i]]

    # ----------------------------------------------------------- layers
    def _attend(self, i: int, h: torch.Tensor, decode: bool) -> torch.Tensor:
        if not self.cfg.is_kda(i):
            return super()._attend(i, h, decode)
        return self._kda_decode(i, h) if decode else self._kda_prefill(i, h)

    def _decay(self, i: int, f: torch.Tensor) -> torch.Tensor:
        """The log-decay of each key channel, ``-exp(A_log) softplus(f +
        dt_bias)``, float32, from ``f = W_fb W_fa x`` [heads, ..., 128]."""
        layer = self.layers[i]
        shape = (-1,) + (1,) * (f.dim() - 2) + (f.shape[-1],)
        return layer.a_neg.view(-1, *shape[1:-1], 1) * F.softplus(f + layer.dt_bias.view(shape))

    def _kda_out(self, i: int, o: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
        """``W_o [RMSNorm_head(o) * sigmoid(W_gb W_ga x)]`` for ``o`` [n, heads,
        128] float32 and the rows' ``W_ga x``."""
        cfg, layer = self.cfg, self.layers[i]
        gate = F.linear(ga, layer.g_b).float().view(o.shape).sigmoid()
        o = F.rms_norm(o, (o.shape[-1],), layer.o_norm, cfg.rms_norm_eps) * gate
        return F.linear(o.to(self.dtype).flatten(1), layer.o)

    def _kda_prefill(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The layer over the prompt from a zero state, its rows in the
        chunked layout of ``ops/kda`` (head-major, whole chunks): the
        convolutions from zero inputs (their last 3 inputs kept), the
        chunked recurrence (its last state kept)."""
        cfg, layer, j = self.cfg, self.layers[i], self._kda_slot[i]
        n, heads, d = x.shape[0], cfg.kda_heads, cfg.kda_head_dim
        width, n_pad = 3 * cfg.kda_width, -(-n // CHUNK) * CHUNK
        proj = F.linear(x, layer.proj)
        fa, ga, b = proj[:, width:].split([d, d, heads], -1)
        xp = torch.cat((proj.new_zeros(cfg.conv_size - 1, width), proj[:, :width]))
        self._conv_tail[j].copy_(xp[n:])
        y = xp[:n] * layer.conv[0]  # the taps as float32 sums of the bf16 inputs, rows in order
        for tap in range(1, cfg.conv_size):
            y.addcmul_(xp[tap:tap + n], layer.conv[tap])
        y = F.silu(y, inplace=True).view(n, 3 * heads, d)
        q, k, v = to_blocks(y.transpose(0, 1), n_pad).split(heads)
        q.mul_(torch.rsqrt(q.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5)
        k.mul_(torch.rsqrt(k.square().sum(-1, keepdim=True) + L2_EPS))
        g = self._decay(i, to_blocks(F.linear(fa, layer.f_b).view(n, heads, d).transpose(0, 1),
                                     n_pad))
        g.view(heads, n_pad, d)[:, n:] = 0.0  # past the prompt: no decay
        beta = to_blocks(b.float().sigmoid().t()[..., None], n_pad)
        o = kda_chunked(q, k, v, g, beta, self._kda_state[j])[:n]
        return self._kda_out(i, o, ga)

    def _kda_decode(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """One token: its projections; the convolutions over the kept inputs
        and this one (which joins them), one step of the recurrence on the
        kept state and the gated norm in ``kda_decode_step`` (one kernel on
        the card); the output projection."""
        cfg, layer, j = self.cfg, self.layers[i], self._kda_slot[i]
        heads, d, width = cfg.kda_heads, cfg.kda_head_dim, 3 * cfg.kda_width
        proj = F.linear(x, layer.proj)
        fa, ga, b = proj[:, width:].split([d, d, heads], -1)
        window = torch.cat((self._conv_tail[j], proj[:, :width]))
        self._conv_tail[j].copy_(window[1:])
        g = self._decay(i, F.linear(fa, layer.f_b).view(heads, d))
        o = kda_decode_step(window, layer.conv, g, F.linear(ga, layer.g_b), b, layer.o_norm,
                            self._kda_state[j], cfg.rms_norm_eps)
        return F.linear(o, layer.o)

    def _moe(self, i: int, x32: torch.Tensor, count: bool) -> torch.Tensor:
        """Sigmoid router on the float32 rows over all routed experts; the
        top-k on the scores plus the gate's correction bias; the chosen
        unbiased scores renormalised and scaled; the held experts' part
        (``_routed``); the shared expert; float32 sum."""
        cfg, layer = self.cfg, self.layers[i]
        scores = F.linear(x32, layer.router).sigmoid()
        expert = torch.topk(scores + self._score_bias[i], cfg.num_experts_per_tok, -1).indices
        weight = scores.gather(1, expert)
        if cfg.norm_topk_prob:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        weight = weight * cfg.routed_scaling_factor
        if cfg.first_expert:  # this card's experts first
            expert = (expert - cfg.first_expert) % cfg.n_routed_experts
        x = x32.to(self.dtype)
        out = _routed(layer, x, weight, expert, cfg.n_routed_experts,
                      self._expert_counts if count else self._decode_counts)
        if layer.gate_up is not None:
            out += _swiglu(x, layer.gate_up, layer.down)
        return out

    # ----------------------------------------------------------- calls
    def prefill(self, ids: torch.Tensor) -> torch.Tensor:
        """``DeepseekV2.prefill``; ``kda_launches``: the state pass kernel's
        launches (one a KDA layer on the card, none on the CPU)."""
        launched = kda_state_pass.launches
        self._decode_counts.zero_()
        logits = super().prefill(ids)
        self.kda_launches = kda_state_pass.launches - launched
        return logits

    def prefill_counts(self) -> dict:
        """``DeepseekV2``'s counts (``expert_tokens``: the held experts'
        routed pairs) and ``kda_launches``."""
        return {**super().prefill_counts(), "kda_launches": self.kda_launches}

    def decode_counts(self) -> dict:
        """The decode steps' routed pairs since the last prefill that this
        card's experts took (one copy from the device)."""
        return {"routed_pairs_held": int(self._decode_counts.sum())}

    def _warm_decode_step(self) -> None:
        """``DeepseekV2``'s, with the KDA states, the convolution inputs and
        the decode counts put back after it: unlike a latent row, they
        would otherwise take the step twice."""
        kept = (self._kda_state, self._conv_tail, self._decode_counts)
        saved = [t.clone() for t in kept]
        super()._warm_decode_step()
        for t, old in zip(kept, saved):
            t.copy_(old)
