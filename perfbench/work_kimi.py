"""Work counts of the Kimi-Linear generator: operations and bytes from
shapes and the port's counts, beside ``work_dsv2.py``'s. Nothing here reads
the program.

``cfg`` is the configuration file's top level (the published
``config.json``, ``num_experts`` the experts held, ``expert_parallel`` the
cards sharing them). A token's products are those of its active weights
this card holds: each KDA layer's projections (q, k, v, f_a, f_b, b, g_a,
g_b, o) or each MLA layer's (``q_proj``, ``kv_a_proj_with_mqa``,
``kv_b_proj``, ``o_proj``), the dense SwiGLU of layer 0, and in each MoE
layer the router (to all routed experts) and the shared expert; the routed
experts' products are counted from the port's own count of the (token,
expert) pairs this card's experts took (the sum of the ``generator.prefill``
span's ``expert_tokens``, the ``generator.decode`` span's ``routed_pairs_held``). Attention's own
products are counted at the algorithm's widths: in a prefill causal MLA at
q/k 192 and v 128, and KDA's chunked form (``kda_chunk_flops``); in a
decode step the absorbed MLA over the latent cache and one step of KDA's
recurrence. The head runs once a call in a prefill and once a decode step.
"""

from __future__ import annotations

from . import work_dsv2

ITEM = 2  # bytes of a bf16 value
STATE_ITEM = 4  # bytes of a float32 KDA state value
CHUNK = 64  # the port's KDA chunk


def _kda(cfg: dict) -> tuple:
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], len(lin["kda_layers"]), len(lin["full_attn_layers"])


def _is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg.get("moe_layer_freq", 1) == 0


def kda_params(cfg: dict) -> int:
    """Weights of one KDA layer's products."""
    h = cfg["hidden_size"]
    heads, d, _, _ = _kda(cfg)
    hk = heads * d
    return 3 * h * hk + 2 * h * d + h * heads + 2 * d * hk + hk * h


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def shared_params(cfg: dict) -> int:
    """Weights every token passes through in all layers, the routed
    experts, the embedding and the head aside."""
    h = cfg["hidden_size"]
    heads, d, n_kda, n_mla = _kda(cfg)
    routed = cfg["num_experts"] * cfg.get("expert_parallel", 1)
    mla = {k: cfg[k] for k in ("hidden_size", "num_attention_heads", "qk_nope_head_dim",
                               "qk_rope_head_dim", "v_head_dim", "kv_lora_rank")}
    total = n_kda * kda_params(cfg) + n_mla * work_dsv2.attention_params(mla)
    for i in range(cfg["num_hidden_layers"]):
        if _is_moe(cfg, i):
            total += h * routed + expert_params(cfg) * (cfg.get("num_shared_experts") or 0)
        else:
            total += 3 * h * cfg["intermediate_size"]
    return total


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def kda_chunk_flops(n: int, cfg: dict) -> float:
    """KDA's chunked form over ``n`` tokens in all KDA layers, a head and
    chunk of C: the intra-chunk decayed products P and A (lower triangles,
    C (C + 1) / 2 pairs of K each), the triangular solve for [U0 | W] (C (C
    - 1) / 2 rows of K + V), P W and P U0 (lower triangles), and the state
    pass (U = U0 - W S, O = O0 + Q' S, S <- g S + Kh^T U: 3 products of C K
    V)."""
    heads, d, n_kda, _ = _kda(cfg)
    c, chunks = CHUNK, -(-n // CHUNK)
    tri = c * (c + 1) / 2
    per = 2 * 2 * tri * d + 2 * (c * (c - 1) / 2) * 2 * d + 2 * tri * 2 * d + 3 * 2 * c * d * d
    return float(n_kda * heads * chunks * per)


def kda_scan_work(n: int, cfg: dict) -> dict:
    """One launch of the state pass over ``n`` tokens' chunks, one KDA
    layer: reads W, Q', Kh, U0, O0 ([heads, chunks, C, 128] float32 each),
    the chunk decays, the first state; writes O and the last state; three
    products of C x 128 x 128 a chunk and head."""
    heads, d, _, _ = _kda(cfg)
    chunks = -(-n // CHUNK)
    rows = heads * chunks * CHUNK
    return {"bytes": STATE_ITEM * (6 * rows * d + heads * chunks * d + 2 * heads * d * d),
            "flops": 3 * 2 * rows * d * d, "dtype": "bfloat16"}


def prefill_flops(n: int, held_pairs: int, cfg: dict) -> float:
    """A prefill of ``n`` tokens whose held experts took ``held_pairs``
    (token, expert) pairs over all layers."""
    heads, _, _, n_mla = _kda(cfg)
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    mla = 2 * cfg["num_attention_heads"] * n * (n + 1) / 2 * (qk + cfg["v_head_dim"]) * n_mla
    return (2.0 * n * shared_params(cfg) + 2.0 * held_pairs * expert_params(cfg) + mla
            + kda_chunk_flops(n, cfg) + 2.0 * head_params(cfg))


def _absorbed(keys: int, cfg: dict) -> float:
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    return 2.0 * cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"] * rank + keys * (rank + rope)
                                               + keys * rank + rank * cfg["v_head_dim"])


def decode_flops(context: int, steps: int, held_pairs: int, cfg: dict) -> float:
    """``steps`` decode steps after a prompt of ``context`` tokens (step j
    attends to ``context + j + 1`` positions) whose held experts took
    ``held_pairs`` pairs in all: the shared weights and the head a step,
    the absorbed MLA, one KDA step (decay, S^T k, the update, S^T q: 7 K V a
    head), the held experts' pairs."""
    heads, d, n_kda, n_mla = _kda(cfg)
    per_step = 2.0 * (shared_params(cfg) + head_params(cfg)) + n_kda * heads * 7 * d * d
    attn = sum(_absorbed(context + j + 1, cfg) for j in range(steps)) * n_mla
    return per_step * steps + attn + 2.0 * held_pairs * expert_params(cfg)


def decode_bytes(context: int, steps: int, held_pairs: int, cfg: dict) -> float:
    """The least bytes of ``steps`` decode steps: each step reads the shared
    weights, the head, the MLA layers' latent cache at its length and
    reads and writes every KDA state; the held experts' weights once a
    pair (one token a step: its pairs are distinct experts)."""
    heads, d, n_kda, n_mla = _kda(cfg)
    width = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    cache = sum(n_mla * (context + j + 1) * width for j in range(steps))
    return (ITEM * ((shared_params(cfg) + head_params(cfg)) * steps + cache
                    + held_pairs * expert_params(cfg))
            + STATE_ITEM * 2 * n_kda * heads * d * d * steps)
