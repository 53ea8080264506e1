"""DeepSeek-V2 (latent attention and DeepSeekMoE), the native answer generator.

The layer equations of the published ``modeling_deepseek.py``
(arXiv:2405.04434 §2) at the widths a DeepSeek-V2 ``config.json`` gives
(``DeepseekV2Config.from_hf``); the defaults are DeepSeek-V2-Lite's: 27
layers, hidden 2,048, vocabulary 102,400, untied head.

- Attention (MLA, no q-LoRA): ``q = W_q x`` per head splits into
  ``q_nope`` (128) and ``q_pe`` (64); ``[c_kv, k_pe] = W_kva x``, with
  ``c_kv`` (512) RMS-normalised and ``k_pe`` one 64-wide key shared by all
  heads; ``[k_nope, v] = W_kvb c_kv`` per head. YaRN rope on ``q_pe`` and
  ``k_pe``. Scores ``(q_nope k_nope + q_pe k_pe) * d_qk^-1/2 * m^2``,
  ``m = 0.1 mscale_all_dim ln(factor) + 1``.
- Layers below ``first_k_dense_replace`` hold a SwiGLU MLP; the others a
  router (a float32 linear map to the routed experts, float32 softmax,
  greedy top-k, ``norm_topk_prob``, ``routed_scaling_factor``), the chosen
  experts' SwiGLUs weighted by it, and the shared experts, one SwiGLU of
  ``n_shared_experts`` times the expert width that every token passes.
- Pre-norm residual blocks, RMSNorm (eps ``rms_norm_eps``), final norm,
  ``lm_head``.

The latent cache: per layer and position the normalised ``c_kv`` and the
roped ``k_pe``, 576 values (not 16 heads' keys and values, 8.9 times more).
It is one buffer ``[layers, capacity, 576]``, kept across calls and grown,
by whole steps of ``RESERVE_STEP`` positions, only when a call needs more.

Two attention paths. ``prefill`` expands keys and values from the latent
rows (``W_kvb c_kv``, one product) and runs causal attention at MLA's own
widths through ``ops/mla_attention.mla_prefill_attention``: q and k 192
deep, v 128 wide, the rope key one column block all heads share, each
operand a view of where the layer has it (no padding, no expanded or
concatenated copy), the output [n, heads x 128] straight into ``W_o``; on
the card that is the kernel ``csrc/mla_prefill_attention.cu``, on the CPU
its plain version. The head runs at the last position only. ``decode``
never expands the cache: ``W_UK`` is absorbed into the query (``q_nope
W_UK`` scores the 512 latent values directly) and ``W_UV`` into the
output (the probabilities weight the latent rows, then ``W_UV`` maps them
per head). A decode step takes its token and position from device buffers
and scores every reserved row, those past its position masked, so its
shapes are the cache's: on the card it is captured once as a CUDA graph
and replayed. Eager, its ~1,200 launches held the card to the host's
pace (20-30 ms a step on an H100 that needs ~7.6 replayed, and drifting
with the host's load).

The MoE layer groups tokens by expert. A prefill or a decode step sorts
its (token, choice) pairs by expert and runs all the groups in one grouped
product (``torch._grouped_mm``, the group ends on the device): no host
wait, no padding, where a loop over 64 experts would leave the card
waiting on the host's launches. The experts' weights are read where they
lie: a decode step that first gathered its six experts' weights (a 104 MB
copy a layer, read again by the product) took 7.1 ms on an H100 where
the grouped product takes 6.65. The tokens each expert got in a prefill
are summed over the layers on the device; ``expert_tokens`` copies the
sum once.

Layout: ``load_state_dict`` takes the published checkpoint's names
(``model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight``, ...) and copies
them into ``_Layer``s: ``q_proj`` and ``kv_a_proj_with_mqa`` stacked into
one product (rows reordered so the rope runs once for the queries and the
key), gate and up stacked, the routed experts stacked by expert;
``state_dict`` gives them back under the same names. The rope rotates
interleaved pairs (``modeling_deepseek`` first moves each pair into
halves; queries and keys both stay interleaved here, so every score is
the same).

Precision "bfloat16": weights, activations and every product in bf16 with
float32 accumulation; the residual stream, RMSNorm, the rotary embedding,
both softmaxes (attention and router), the router's product and its
top-k, and the sum of the routed and shared experts in float32.
"float32" runs all of it in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.mla_attention import mla_prefill_attention

RESERVE_STEP = 1024  # positions: the cache grows by whole steps


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    max_position_embeddings: int = 163840
    dtype: str = "bfloat16"  # "bfloat16" or "float32"

    @classmethod
    def from_hf(cls, hf: dict) -> "DeepseekV2Config":
        """From a published ``config.json``, in its ``torch_dtype`` (bf16
        where it names none); what this module does not compute (q-LoRA,
        grouped routing, other scoring, biases, other dtypes) raises."""
        dtype = hf.get("torch_dtype", "bfloat16")
        unsupported = {
            "q_lora_rank": hf.get("q_lora_rank") is not None,
            "topk_method": hf.get("topk_method", "greedy") != "greedy",
            "scoring_func": hf.get("scoring_func", "softmax") != "softmax",
            "n_group": hf.get("n_group", 1) not in (1, None),
            "attention_bias": bool(hf.get("attention_bias", False)),
            "hidden_act": hf.get("hidden_act", "silu") != "silu",
            "rope_scaling": (hf.get("rope_scaling") or {}).get("type") != "yarn",
            "tie_word_embeddings": bool(hf.get("tie_word_embeddings", False)),
            "torch_dtype": dtype not in ("bfloat16", "float32"),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepSeek-V2 settings not supported: {', '.join(bad)}")
        rs = hf["rope_scaling"]
        return cls(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            n_routed_experts=hf["n_routed_experts"] or 0,
            n_shared_experts=hf["n_shared_experts"] or 0,
            num_experts_per_tok=hf["num_experts_per_tok"],
            first_k_dense_replace=hf["first_k_dense_replace"],
            moe_layer_freq=hf["moe_layer_freq"], kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"], qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"], rope_theta=float(hf["rope_theta"]),
            rope_factor=float(rs["factor"]),
            rope_original_max_position=rs["original_max_position_embeddings"],
            rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
            rope_mscale=float(rs["mscale"]), rope_mscale_all_dim=float(rs["mscale_all_dim"]),
            rms_norm_eps=hf["rms_norm_eps"], norm_topk_prob=bool(hf["norm_topk_prob"]),
            routed_scaling_factor=float(hf["routed_scaling_factor"]),
            max_position_embeddings=hf["max_position_embeddings"], dtype=dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        """Values a token keeps per layer: the latent row and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.qk_head_dim ** -0.5 * m * m

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# ------------------------------------------------------------------ YaRN
def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """The rope's ``dim / 2`` inverse frequencies, float32: extrapolated
    (the base's) above ``beta_fast`` rotations, interpolated (divided by
    ``factor``) below ``beta_slow``, a linear ramp between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (cfg.rope_factor * base ** exps)
    low = max(math.floor(_correction_dim(cfg.rope_beta_fast, dim, base,
                                         cfg.rope_original_max_position)), 0)
    high = min(math.ceil(_correction_dim(cfg.rope_beta_slow, dim, base,
                                         cfg.rope_original_max_position)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the base's frequency
    return inter * (1 - keep) + extra * keep


def rope_factors(cfg: DeepseekV2Config, n: int, device) -> torch.Tensor:
    """``m * exp(i theta)``, complex64 ``[n, rope_dim / 2]``: position ``t``'s
    angles ``t * yarn_inv_freq``, ``m = mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)`` (1 for V2-Lite)."""
    freqs = torch.outer(torch.arange(n, dtype=torch.float32), yarn_inv_freq(cfg))
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return torch.polar(torch.full_like(freqs, m), freqs).to(device)


def apply_rope(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """``x[..., rope_dim]`` roped in float32, its pairs ``(2j, 2j + 1)``
    rotated by ``factors[..., j]``. ``modeling_deepseek`` moves each pair
    into halves first (``j``, ``j + rope_dim / 2``) and rotates the halves;
    the values are the same, in the interleaved order, and queries and
    keys are both kept so, which leaves every score unchanged."""
    z = torch.view_as_complex(x.float().contiguous().unflatten(-1, (-1, 2)))
    return torch.view_as_real(z * factors).flatten(-2)


# ----------------------------------------------------------- parameters
def param_shapes(cfg: DeepseekV2Config) -> Dict[str, tuple]:
    """Name -> shape of every weight, with the published checkpoint's names,
    in ``torch.nn.Linear``'s (out, in) layout."""
    h, heads = cfg.hidden_size, cfg.num_attention_heads
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        a = f"model.layers.{i}.self_attn."
        shapes.update({
            a + "q_proj.weight": (heads * cfg.qk_head_dim, h),
            a + "kv_a_proj_with_mqa.weight": (cfg.cache_width, h),
            a + "kv_a_layernorm.weight": (cfg.kv_lora_rank,),
            a + "kv_b_proj.weight": (heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                     cfg.kv_lora_rank),
            a + "o_proj.weight": (h, heads * cfg.v_head_dim),
            f"model.layers.{i}.input_layernorm.weight": (h,),
            f"model.layers.{i}.post_attention_layernorm.weight": (h,),
        })
        m = f"model.layers.{i}.mlp."
        if cfg.is_moe(i):
            shapes[m + "gate.weight"] = (cfg.n_routed_experts, h)
            mlps = [(f"{m}experts.{e}.", cfg.moe_intermediate_size)
                    for e in range(cfg.n_routed_experts)]
            if cfg.n_shared_experts:
                mlps.append((m + "shared_experts.",
                             cfg.moe_intermediate_size * cfg.n_shared_experts))
        else:
            mlps = [(m, cfg.intermediate_size)]
        for prefix, f in mlps:
            shapes.update({prefix + "gate_proj.weight": (f, h),
                           prefix + "up_proj.weight": (f, h),
                           prefix + "down_proj.weight": (h, f)})
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return shapes


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 (``w`` float32)."""
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps)


def _swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate x) * up x)``, ``gate_up`` the two stacked by rows."""
    g, u = F.linear(x, gate_up).chunk(2, -1)
    return F.linear(F.silu(g) * u, down)


def _routed(layer, x: torch.Tensor, weight: torch.Tensor, expert: torch.Tensor, n_routed: int,
            counts_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' weighted sum, float32 [n, hidden], for rows ``x``
    whose ``k`` choices among ``n_routed`` experts are ``expert`` [n, k]
    with ``weight``: the (token, choice) pairs sorted by expert, every
    group in one grouped product (``torch._grouped_mm``, the group ends on
    the device). The layer holds the first ``held`` experts
    (``layer.experts_gate_up``'s first dimension): pairs routed to the
    others add nothing, as on a card that shares the layer with others
    (expert parallelism), and the grouped product stops at the held pairs'
    end (its rows past that are never written, so they are zeroed).
    ``counts_to``: the held experts' pair counts are added to it."""
    n, k = expert.shape
    held = layer.experts_gate_up.shape[0]
    flat = expert.flatten()
    order = torch.argsort(flat, stable=True)
    # not bincount: on the card it reads the largest id back to the host
    counts = flat.new_zeros(n_routed).scatter_add_(0, flat, torch.ones_like(flat))[:held]
    if counts_to is not None:
        counts_to += counts
    ends = counts.cumsum(0).to(torch.int32)
    g, u = torch._grouped_mm(x[order // k], layer.experts_gate_up.transpose(1, 2),
                             offs=ends).chunk(2, -1)
    y = torch._grouped_mm(F.silu(g) * u, layer.experts_down.transpose(1, 2), offs=ends)
    if held < n_routed:
        rows = torch.arange(n * k, device=y.device)
        y.masked_fill_((rows >= ends[-1])[:, None], 0.0)
    ys = torch.empty_like(y)
    ys[order] = y  # back to (token, choice) order
    return (ys.view(n, k, -1).float() * weight[..., None]).sum(1)


@dataclasses.dataclass
class _Layer:
    """One layer's weights as the program holds them (built by
    ``DeepseekV2.load_state_dict``): norms in float32; ``q_proj`` and
    ``kv_a_proj_with_mqa`` stacked by rows (one product); gate and up
    stacked by rows; the routed experts stacked by expert."""
    norm_in: torch.Tensor
    norm_post: torch.Tensor
    qkv_a: torch.Tensor
    kv_norm: torch.Tensor
    kv_b: torch.Tensor
    o: torch.Tensor
    gate_up: torch.Tensor  # the dense MLP, or the shared experts
    down: torch.Tensor
    w_uk: Optional[torch.Tensor] = None  # [heads, nope, rank], a view of kv_b
    w_uv_t: Optional[torch.Tensor] = None  # [heads, rank, v], a view of kv_b
    router: Optional[torch.Tensor] = None  # float32 [experts, hidden]
    experts_gate_up: Optional[torch.Tensor] = None  # [experts, 2 width, hidden]
    experts_down: Optional[torch.Tensor] = None  # [experts, hidden, width]


class DeepseekV2:
    """The model on one device, with its latent cache. ``prefill(ids)``
    fills positions ``0..n-1`` of the cache and returns the float32 logits
    of the last; ``decode(token, pos)`` writes position ``pos`` and returns
    its logits. Weights come from ``load_state_dict`` (checkpoint names;
    copied into the program's layout, ``_Layer``)."""

    def __init__(self, cfg: DeepseekV2Config, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = cfg.compute_dtype
        self.layers: List[_Layer] = []
        self.embed = self.norm = self.head = None
        self.cache: Optional[torch.Tensor] = None  # [layers, capacity, cache_width]
        self._rope: Optional[torch.Tensor] = None
        self._expert_counts: Optional[torch.Tensor] = None
        self.attention_launches = 0  # the attention kernel's, in the last prefill
        self._step = None  # the decode step's device inputs, output and graph

    @property
    def expert_tokens(self) -> List[int]:
        """Tokens routed to each expert in the last prefill, summed over its
        layers (one copy from the device)."""
        return [] if self._expert_counts is None else self._expert_counts.tolist()

    @property
    def loaded(self) -> bool:
        return self.embed is not None

    # --------------------------------------------------------- weights
    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        shapes = param_shapes(cfg)
        missing = sorted(set(shapes) - set(sd))
        extra = sorted(set(sd) - set(shapes))
        if missing or extra:
            raise KeyError(f"state dict: missing {missing[:4]}, unexpected {extra[:4]}")
        for name, shape in shapes.items():
            if tuple(sd[name].shape) != shape:
                raise ValueError(f"{name}: shape {tuple(sd[name].shape)}, expected {shape}")

        def w(name, dtype=self.dtype):
            return sd[name].to(self.device, dtype)

        def rows(*names):
            return torch.cat([w(n) for n in names])

        self.layers, self._step = [], None
        for i in range(cfg.num_hidden_layers):
            a, m = f"model.layers.{i}.self_attn.", f"model.layers.{i}.mlp."
            mlp = m + "shared_experts." if cfg.is_moe(i) else m
            has_mlp = not cfg.is_moe(i) or cfg.n_shared_experts
            layer = _Layer(
                norm_in=w(f"model.layers.{i}.input_layernorm.weight", torch.float32),
                norm_post=w(f"model.layers.{i}.post_attention_layernorm.weight", torch.float32),
                qkv_a=self._stack_qkv_a(w(a + "q_proj.weight"), w(a + "kv_a_proj_with_mqa.weight")),
                kv_norm=w(a + "kv_a_layernorm.weight", torch.float32),
                kv_b=w(a + "kv_b_proj.weight"), o=w(a + "o_proj.weight"),
                gate_up=rows(mlp + "gate_proj.weight", mlp + "up_proj.weight") if has_mlp else None,
                down=w(mlp + "down_proj.weight") if has_mlp else None)
            w_ukv = layer.kv_b.view(cfg.num_attention_heads, -1, cfg.kv_lora_rank)
            layer.w_uk = w_ukv[:, : cfg.qk_nope_head_dim]
            layer.w_uv_t = w_ukv[:, cfg.qk_nope_head_dim:].transpose(1, 2)
            if cfg.is_moe(i):
                experts = range(cfg.n_routed_experts)
                layer.router = w(m + "gate.weight", torch.float32)
                layer.experts_gate_up = torch.stack([rows(f"{m}experts.{e}.gate_proj.weight",
                                                          f"{m}experts.{e}.up_proj.weight")
                                                     for e in experts])
                layer.experts_down = torch.stack([w(f"{m}experts.{e}.down_proj.weight")
                                                  for e in experts])
            self.layers.append(layer)
        self.embed = w("model.embed_tokens.weight")
        self._expert_counts = torch.zeros(cfg.n_routed_experts, dtype=torch.long,
                                          device=self.device)
        self.norm = w("model.norm.weight", torch.float32)
        self.head = w("lm_head.weight")

    def _stack_qkv_a(self, q: torch.Tensor, kv_a: torch.Tensor) -> torch.Tensor:
        """``q_proj`` and ``kv_a_proj_with_mqa`` as one product's rows:
        every head's nope rows, the latent rows, every head's rope rows and
        the shared rope key's, so the rope runs once over the last
        ``heads + 1`` groups of ``rope_dim``."""
        cfg = self.cfg
        q = q.view(cfg.num_attention_heads, cfg.qk_head_dim, -1)
        nope, pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], 1)
        c, k_pe = kv_a.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim])
        return torch.cat([nope.flatten(0, 1), c, pe.flatten(0, 1), k_pe])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights under the checkpoint's names: views of the program's
        tensors (the norms and the router in float32), but ``q_proj`` and
        ``kv_a_proj_with_mqa``, put back together from ``qkv_a``."""
        cfg = self.cfg
        heads, nope, rope, rank = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                                   cfg.qk_rope_head_dim, cfg.kv_lora_rank)
        out = {"model.embed_tokens.weight": self.embed, "model.norm.weight": self.norm,
               "lm_head.weight": self.head}
        for i, layer in enumerate(self.layers):
            p, a, m = f"model.layers.{i}.", f"model.layers.{i}.self_attn.", f"model.layers.{i}.mlp."
            nope_rows, c_rows, pe_rows, k_pe_rows = layer.qkv_a.split(
                [heads * nope, rank, heads * rope, rope])
            out.update({
                p + "input_layernorm.weight": layer.norm_in,
                p + "post_attention_layernorm.weight": layer.norm_post,
                a + "q_proj.weight": torch.cat(
                    (nope_rows.view(heads, nope, -1), pe_rows.view(heads, rope, -1)), 1).flatten(0, 1),
                a + "kv_a_proj_with_mqa.weight": torch.cat((c_rows, k_pe_rows)),
                a + "kv_a_layernorm.weight": layer.kv_norm,
                a + "kv_b_proj.weight": layer.kv_b, a + "o_proj.weight": layer.o})
            mlps = []
            if layer.gate_up is not None:
                mlps.append((m + "shared_experts." if cfg.is_moe(i) else m,
                             layer.gate_up, layer.down))
            if cfg.is_moe(i):
                out[m + "gate.weight"] = layer.router
                mlps += [(f"{m}experts.{e}.", layer.experts_gate_up[e], layer.experts_down[e])
                         for e in range(cfg.n_routed_experts)]
            for prefix, gate_up, down in mlps:
                g, u = gate_up.chunk(2)
                out.update({prefix + "gate_proj.weight": g, prefix + "up_proj.weight": u,
                            prefix + "down_proj.weight": down})
        return out

    def reserve(self, positions: int) -> None:
        """A cache (and rope factors) of at least ``positions``, kept and
        reused; a new one holds a whole number of ``RESERVE_STEP``s, so
        prompts of about one length share one cache and one decode graph."""
        cfg = self.cfg
        if positions > cfg.max_position_embeddings:
            raise ValueError(f"{positions} positions; the model takes "
                             f"{cfg.max_position_embeddings}")
        if self.cache is not None and self.cache.shape[1] >= positions:
            return
        positions = min(-(-positions // RESERVE_STEP) * RESERVE_STEP,
                        cfg.max_position_embeddings)
        self.cache = self._step = None  # free the old ones first
        # zeros: a decode step reads every reserved row (those past it with
        # probability 0, which a NaN of fresh memory would still turn to NaN)
        self.cache = torch.zeros(self._cached_layers(), positions, cfg.cache_width,
                                 device=self.device, dtype=self.dtype)
        self._rope = self._rope_table(positions)

    def _cached_layers(self) -> int:
        """Layers with a latent cache: every one."""
        return self.cfg.num_hidden_layers

    def _rope_table(self, positions: int) -> Optional[torch.Tensor]:
        return rope_factors(self.cfg, positions, self.device)

    def _cache_of(self, i: int) -> torch.Tensor:
        """Layer ``i``'s latent cache rows [capacity, cache_width]."""
        return self.cache[i]

    # ----------------------------------------------------------- layers
    def _latent(self, i: int, x: torch.Tensor, factors: Optional[torch.Tensor]) -> tuple:
        """Layer ``i``'s queries for rows ``x`` at the positions whose rope
        ``factors`` are given: (q_nope, roped q_pe, the rows' cache values:
        the normalised latent and the roped key). ``factors`` None: no rope
        (a NoPE layer's q_pe and k_pe are used as they are)."""
        cfg, layer = self.cfg, self.layers[i]
        n, heads, rank = x.shape[0], cfg.num_attention_heads, cfg.kv_lora_rank
        nope = heads * cfg.qk_nope_head_dim
        qa = F.linear(x, layer.qkv_a)
        pe = qa[:, nope + rank:].view(n, heads + 1, -1)
        if factors is not None:
            pe = apply_rope(pe, factors[:, None])
        c = _rms(qa[:, nope:nope + rank], layer.kv_norm, cfg.rms_norm_eps)
        rows = torch.cat((c, pe[:, heads]), -1).to(self.dtype)
        return qa[:, :nope].view(n, heads, -1), pe[:, :heads].to(self.dtype), rows

    def _attend_prefill(self, i: int, x: torch.Tensor) -> torch.Tensor:
        cfg, layer = self.cfg, self.layers[i]
        n, heads, rank = x.shape[0], cfg.num_attention_heads, cfg.kv_lora_rank
        q_nope, q_pe, rows = self._latent(i, x, None if self._rope is None else self._rope[:n])
        self._cache_of(i)[:n] = rows
        kv = F.linear(rows[:, :rank], layer.kv_b).view(n, heads, -1)
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
        o = mla_prefill_attention(q_nope, q_pe, k_nope, rows[:, rank:], v, cfg.softmax_scale)
        return F.linear(o, layer.o)

    def _attend_decode(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The decode step's position (``_step``'s, on the device) against
        the cache, ``W_UK`` and ``W_UV`` absorbed: scores over the 576 cached
        values of every reserved position, those past the step's masked,
        the probabilities over the 512 latent ones, then ``W_UV`` per head."""
        cfg, layer, step = self.cfg, self.layers[i], self._step
        factors = None if self._rope is None else self._rope.index_select(0, step["pos"])
        q_nope, q_pe, row = self._latent(i, x, factors)
        rows = self._cache_of(i)
        rows.index_copy_(0, step["pos"], row)
        q_lat = torch.bmm(q_nope.transpose(0, 1), layer.w_uk)  # [heads, 1, rank]
        q = torch.cat((q_lat[:, 0], q_pe[0]), -1) * cfg.softmax_scale  # [heads, cache_width]
        scores = (q @ rows.t()).masked_fill_(step["after"], float("-inf"))
        probs = torch.softmax(scores, -1, dtype=torch.float32).to(self.dtype)
        ctx = probs @ rows[:, : cfg.kv_lora_rank]  # [heads, rank]
        o = torch.bmm(ctx[:, None], layer.w_uv_t)  # [heads, 1, v]
        return F.linear(o.view(1, -1), layer.o)

    def _moe(self, i: int, x32: torch.Tensor, count: bool) -> torch.Tensor:
        """Router on the float32 rows (softmax, greedy top-k); the routed
        experts (``_routed``); the shared experts; float32 sum. ``count``:
        add the pairs to ``expert_tokens`` (a prefill's, not a decode
        step's)."""
        cfg, layer = self.cfg, self.layers[i]
        weight, expert = torch.topk(F.linear(x32, layer.router).softmax(-1),
                                    cfg.num_experts_per_tok, -1)
        if cfg.norm_topk_prob:
            weight = weight / weight.sum(-1, keepdim=True)
        if cfg.routed_scaling_factor != 1:
            weight = weight * cfg.routed_scaling_factor
        x = x32.to(self.dtype)
        out = _routed(layer, x, weight, expert, cfg.n_routed_experts,
                      self._expert_counts if count else None)
        if layer.gate_up is not None:
            out += _swiglu(x, layer.gate_up, layer.down)
        return out

    def _attend(self, i: int, h: torch.Tensor, decode: bool) -> torch.Tensor:
        return self._attend_decode(i, h) if decode else self._attend_prefill(i, h)

    def _block(self, i: int, x: torch.Tensor, decode: bool) -> torch.Tensor:
        cfg, layer = self.cfg, self.layers[i]
        h = _rms(x, layer.norm_in, cfg.rms_norm_eps).to(self.dtype)
        x = x + self._attend(i, h, decode)
        h = _rms(x, layer.norm_post, cfg.rms_norm_eps)
        if cfg.is_moe(i):
            return x + self._moe(i, h, not decode)
        return x + _swiglu(h.to(self.dtype), layer.gate_up, layer.down)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = _rms(x, self.norm, self.cfg.rms_norm_eps).to(self.dtype)
        return F.linear(x, self.head).float()[0]

    # ----------------------------------------------------------- calls
    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor) -> torch.Tensor:
        """Positions ``0..len(ids)-1`` into the cache; the last one's logits.
        ``expert_tokens``: tokens routed to each expert, summed over layers;
        ``attention_launches``: launches of the attention kernel (one a layer
        on the card, none on the CPU)."""
        self.reserve(len(ids))
        self._expert_counts.zero_()
        launched = mla_prefill_attention.launches
        x = F.embedding(ids, self.embed).float()  # the residual stream in float32
        for i in range(self.cfg.num_hidden_layers):
            x = self._block(i, x, False)
        self.attention_launches = mla_prefill_attention.launches - launched
        return self._head(x[-1:])

    def prefill_counts(self) -> dict:
        """The last prefill's counts, which the ``generator.prefill`` span
        adds while recording (``expert_tokens`` copies from the device)."""
        return {"expert_tokens": self.expert_tokens,
                "attention_launches": self.attention_launches}

    def decode_counts(self) -> dict:
        """Counts the ``generator.decode`` span adds while recording: none."""
        return {}

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """``token`` (a one-element device tensor) at position ``pos``, which
        the cache must hold; the logits there. The step's inputs go to
        device buffers; on the card the step is one CUDA graph, captured at
        the first step after each ``reserve`` or ``load_state_dict`` (its
        shapes are the reserved cache's, whatever ``pos``), so the host
        launches one graph and not ~1,200 kernels a step."""
        if self.cache is None or pos >= self.cache.shape[1]:
            raise ValueError(f"position {pos} is past the cache; reserve it first")
        if self._step is None:
            self._step = {"token": torch.zeros(1, dtype=torch.long, device=self.device),
                          "pos": torch.zeros(1, dtype=torch.long, device=self.device),
                          "positions": torch.arange(self.cache.shape[1], device=self.device)}
        step = self._step
        step["token"].copy_(token.view(1))
        step["pos"].fill_(pos)
        if self.device.type != "cuda":
            return self._decode_step()
        if "graph" not in step:
            self._warm_decode_step()
            step["graph"] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(step["graph"]):
                step["logits"] = self._decode_step()
        step["graph"].replay()
        return step["logits"].clone()

    def _warm_decode_step(self) -> None:
        """The step once outside the graph, on a side stream, before its
        capture (it writes this position's row, which the graph's replay
        writes again)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_step()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _decode_step(self) -> torch.Tensor:
        step = self._step
        step["after"] = step["positions"] > step["pos"]
        x = F.embedding(step["token"], self.embed).float()
        for i in range(self.cfg.num_hidden_layers):
            x = self._block(i, x, True)
        return self._head(x)
