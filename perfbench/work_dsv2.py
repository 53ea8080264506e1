"""Work counts of the DeepSeek-V2 generator: operations and bytes from
shapes, beside ``work.py``'s. Nothing here reads the program.

``cfg`` is the published ``config.json`` (the configuration file's top
level). A token's products are those of its active weights: attention
(``q_proj``, ``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``) in every
layer, the dense SwiGLU where a layer has one, and in each MoE layer the
router, ``num_experts_per_tok`` routed experts and the shared experts.
Attention's own products are counted at the algorithm's widths: causal
(each query against the keys up to its own) at q/k 192 and v 128 in a
prefill; in a decode step the absorbed form over the latent cache
(``q_nope W_UK``, scores over 576 values, the probabilities over the 512
latent values, ``W_UV``). The head runs once a call in a prefill and once
a decode step.
"""

from __future__ import annotations

ITEM = 2  # bytes of a bf16 value


def _is_moe(cfg: dict, i: int) -> bool:
    return (bool(cfg["n_routed_experts"]) and i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def attention_params(cfg: dict) -> int:
    """Weights of one layer's attention (the two norms' scales aside)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"], cfg["kv_lora_rank"])
    return (h * heads * (nope + rope) + h * (rank + rope) + rank * heads * (nope + v)
            + heads * v * h)


def mlp_params(cfg: dict, i: int) -> int:
    """Weights one token passes through in layer ``i``'s MLP or MoE."""
    h = cfg["hidden_size"]
    if not _is_moe(cfg, i):
        return 3 * h * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    return (h * cfg["n_routed_experts"] + 3 * h * f * cfg["num_experts_per_tok"]
            + 3 * h * f * cfg["n_shared_experts"])


def active_params(cfg: dict) -> int:
    """Weights a token passes through in all layers (embedding and head aside)."""
    return sum(attention_params(cfg) + mlp_params(cfg, i)
               for i in range(cfg["num_hidden_layers"]))


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(n: int, cfg: dict) -> float:
    """A prefill of ``n`` tokens: every token's products, causal attention
    (n (n + 1) / 2 query-key pairs a head and layer at q/k and v widths),
    the head at the last position."""
    heads, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = n * (n + 1) / 2
    attn = 2 * heads * pairs * (qk + cfg["v_head_dim"]) * layers
    return 2.0 * n * active_params(cfg) + attn + 2.0 * head_params(cfg)


def decode_flops(context: int, cfg: dict) -> float:
    """One decode step whose token joins a cache of ``context`` positions
    (it attends to ``context + 1``)."""
    heads, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    keys = context + 1
    absorbed = 2 * heads * (cfg["qk_nope_head_dim"] * rank + keys * (rank + rope)
                            + keys * rank + rank * cfg["v_head_dim"])
    return 2.0 * (active_params(cfg) + head_params(cfg)) + absorbed * layers


def decode_bytes(context: int, cfg: dict) -> float:
    """The least bytes a decode step reads: the active weights, the head
    and the latent cache at its length, in bf16."""
    cache = cfg["num_hidden_layers"] * (context + 1) * (cfg["kv_lora_rank"]
                                                        + cfg["qk_rope_head_dim"])
    return ITEM * float(active_params(cfg) + head_params(cfg) + cache)
