"""The port's Kimi-Linear generator (``models/kimi_linear.py``) and its KDA
operations (``ops/kda.py``) against the plain float32 reference
(``perfbench/reference/kimi_linear.py``) on the CPU, at small widths that
keep Kimi-Linear-48B-A3B's 27-layer pattern (20 KDA, 7 MLA NoPE at 1-based
4, 8, ..., 24, 27; a dense first layer), its routing (sigmoid, 8 a token,
renormalised, times 2.446, one shared expert, half the experts held:
expert parallel 2) and its precision (bf16); the chunked KDA and the state
pass's twin against the token recurrence; the expert share; the
configuration's parsing; ``NativeGenerator``'s choice of model; the spans
and counters. On the card (``-m cuda``): the state pass kernel against its
twin up to the answer cell's 16,896 rows, with its launches, and the
decode kernel against its twin, with its launches.

Tolerances. Float32 against float32 differs only in the order of sums
(the chunked KDA against the reference's other chunks, the grouped experts,
the absorbed decode), so 1e-4 of a logit vector's norm (seen: <= 3e-5).
The chunked forms against the recurrence (float64): 1e-5 of the largest
output (seen: <= 7e-7 in float32). bf16 against float32 is the
configuration's own rounding through 27 layers: 0.4-0.65% of a position's
logits (seen), held to 3% at the prefill's last position and to a median
of 2% over the decode steps; now and then rounding flips a near-tie
routing choice of 8 among 32 experts, which moves a position by up to 8%
(seen), so the worst decode position is held to 15%. Kernel against twin, both float32: every output's and the last
state's difference within 1e-4 of the largest (sums in other orders over
264 chunks).
"""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import kimi_linear as R
from rag_faiss_embedding_tpu_torch.models import kimi_linear as K
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
from rag_faiss_embedding_tpu_torch.ops import kda
from rag_faiss_embedding_tpu_torch.utils import timers

REPO = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((REPO / "perfbench/configs/kimi-linear-48b-a3b.rag-flat-bf16.json").read_text())
HARNESS = ("source", "model", "encoder", "port", "corpus", "rows", "index", "deployment",
           "assumed", "reduced")
KIMI = {k: v for k, v in PUBLISHED.items() if k not in HARNESS}
HF = {**KIMI, "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
      "moe_intermediate_size": 16, "num_attention_heads": 4, "num_key_value_heads": 4,
      "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
      "linear_attn_config": {**KIMI["linear_attn_config"], "num_heads": 2, "head_dim": 32},
      "num_experts": 16, "model_max_length": 4096}
WORDS = ["vector", "search", "tensor", "cores", "shard", "merge", "query", "index",
         "latent", "expert", "cache", "token", "encoder", "answer", "card", "host"]


def _hf(**kw):
    return {**HF, "torch_dtype": "float32", **kw}


def _model(hf, weights):
    m = K.KimiLinear(K.KimiLinearConfig.from_hf(hf), "cpu")
    m.load_state_dict(weights)
    return m


def _ids(n, seed=0):
    return torch.randint(0, HF["vocab_size"], (n,), generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_prefill_logits_match_the_reference(dtype, tol):
    hf = _hf(torch_dtype=dtype)
    w = R.SeededWeights(hf, 3, "cpu")
    ids = _ids(150)
    got = _model(hf, w).prefill(ids)
    want = R.KimiLinearReference(w, hf).logits(ids.tolist())[0]
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype,median,worst", [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 0.15)])
def test_decode_through_the_caches_matches_the_full_forward(dtype, median, worst):
    """Prefill 130 tokens, then 20 decode steps on the given tokens: every
    position's logits against one forward over all of them (the KDA
    states, the convolution inputs and the latent rows carried)."""
    hf = _hf(torch_dtype=dtype)
    w = R.SeededWeights(hf, 4, "cpu")
    ids, n = _ids(150, 1), 130
    m = _model(hf, w)
    m.reserve(150)
    got = torch.stack([m.prefill(ids[:n])] + [m.decode(ids[p:p + 1], p) for p in range(n, 149)])
    want = R.KimiLinearReference(w, hf).logits(ids[:149].tolist(), last=150 - n)
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert err.median() < median and err.max() < worst


def test_a_second_prompt_starts_from_empty_states():
    """A prefill begins from zero KDA states and convolution inputs,
    whatever the call before it left."""
    hf = _hf()
    w = R.SeededWeights(hf, 5, "cpu")
    m = _model(hf, w)
    m.reserve(80)
    m.prefill(_ids(70, 2))
    for p in range(70, 75):
        m.decode(_ids(1, p), p)
    ids = _ids(40, 3)
    assert _rel(m.prefill(ids), R.KimiLinearReference(w, hf).logits(ids.tolist())[0]) < 1e-4


@pytest.mark.parametrize("side", ["reference", "port"])
def test_expert_shares_add_up_to_the_uncut_layer(side):
    """Experts 0-15 plus experts 16-31, the shared expert counted once, make
    the layer with all 32 (float32)."""
    whole = _hf(num_experts=32, expert_parallel=1)
    shares = [_hf(expert_rank=r, expert_parallel=2) for r in (0, 1)]
    x = torch.randn(40, HF["hidden_size"], generator=torch.Generator().manual_seed(6))
    layer, p = 1, "model.layers.1."
    shared = R.KimiLinearReference(None, whole)._mlp(
        x, {k: v.float() for k, v in R.SeededWeights(whole, 7, "cpu").items()
            if k.startswith(p + "block_sparse_moe.shared_experts.")},
        p + "block_sparse_moe.shared_experts.")

    def moe(hf):
        w = R.SeededWeights(hf, 7, "cpu")  # a weight's values depend only on its name
        if side == "reference":
            lw = {k: v.float() for k, v in w.items() if k.startswith(p)}
            return R.KimiLinearReference(w, hf)._moe(x, lw, p + "block_sparse_moe.")
        return _model(hf, w)._moe(layer, x, False)

    got = moe(shares[0]) + moe(shares[1]) - shared
    torch.testing.assert_close(got, moe(whole), rtol=1e-5, atol=1e-5)
    assert (moe(shares[0]) - shared).abs().max() > 0.01  # each share gives a part


def test_prefill_counts_the_pairs_each_held_expert_got():
    hf = _hf()
    m = _model(hf, R.SeededWeights(hf, 8, "cpu"))
    m.prefill(_ids(50))
    c = m.prefill_counts()
    assert len(c["expert_tokens"]) == 16  # the held experts
    # of the 50 x 8 x 26 routed pairs (8 a token, 26 MoE layers), about half here
    assert 0.3 < sum(c["expert_tokens"]) / (50 * 8 * 26) < 0.7
    assert c["kda_launches"] == 0 and c["attention_launches"] == 0  # the CPU: plain versions


def test_caches_hold_the_mla_rows_and_the_kda_states():
    cfg = K.KimiLinearConfig.from_hf(_hf())
    m = _model(_hf(), R.SeededWeights(_hf(), 9, "cpu"))
    m.reserve(100)
    assert tuple(m.cache.shape) == (7, 1024, 32 + 16)  # 7 MLA layers' latent rows
    assert tuple(m._kda_state.shape) == (20, 2, 32, 32)
    assert tuple(m._conv_tail.shape) == (20, 3, 3 * 64)
    assert cfg.mla_layers == (3, 7, 11, 15, 19, 23, 26)


# --------------------------------------------------------------- the KDA
def _kda_inputs(n, heads=3, d=128, seed=0):
    """q^, k^, v, g, beta as a KDA layer makes them, with the reference's
    decay spread (A in [1, 16], dt log-uniform in [1e-4, 1e-1])."""
    g0 = torch.Generator().manual_seed(seed)
    q = F.normalize(torch.randn(n, heads, d, generator=g0), dim=-1) * d ** -0.5
    k = F.normalize(torch.randn(n, heads, d, generator=g0), dim=-1)
    v = torch.randn(n, heads, d, generator=g0)
    a = torch.empty(heads).uniform_(*R.A_RANGE, generator=g0)
    dt = torch.exp(torch.empty(heads, d).uniform_(*map(math.log, R.DT_RANGE), generator=g0))
    bias = dt + torch.log(-torch.expm1(-dt))
    g = -a[:, None] * F.softplus(torch.randn(n, heads, d, generator=g0) * R.DECAY_NOISE + bias)
    return q, k, v, g, torch.rand(n, heads, generator=g0)


def _blocks(q, k, v, g, beta):
    """[n, H, D] rows (and beta [n, H]) in ``ops/kda``'s chunked layout."""
    n_pad = -(-q.shape[0] // kda.CHUNK) * kda.CHUNK
    return [kda.to_blocks(x.transpose(0, 1), n_pad) for x in (q, k, v, g)] + [
        kda.to_blocks(beta.t()[..., None], n_pad)]


def _close(got, want, tol=1e-5):
    assert (got.double() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_chunked_kda_and_the_twin_match_the_recurrence(n):
    ops = _kda_inputs(n, seed=n)
    want_o, want_s = R.kda_recurrent(*(x.double() for x in ops))
    s = torch.empty(3, 128, 128)
    o = kda.kda_chunked(*_blocks(*ops), s)  # on the CPU the pass is the twin
    _close(o[:n], want_o)
    _close(s, want_s)
    w, qp, kh, u0, o0, gamma = kda.chunk_operands(*_blocks(*ops))
    s0 = torch.zeros(3, 128, 128)
    out, last = kda.kda_state_pass_reference(w, qp, kh, u0, o0, gamma, s0)
    _close(out[:n], want_o)
    _close(last, want_s)


@pytest.mark.parametrize("n", [1, 33, 100])
def test_reference_chunked_form_matches_its_recurrence(n):
    ops = _kda_inputs(n, heads=2, d=32, seed=n)
    want_o, want_s = R.kda_recurrent(*(x.double() for x in ops))
    o, s = R.kda_chunked(*ops, chunk=16, group=3)
    _close(o, want_o)
    _close(s, want_s)


def test_decode_step_continues_the_chunked_state():
    ops = _kda_inputs(70, seed=1)
    want_o, _ = R.kda_recurrent(*(x.double() for x in ops))
    s = torch.empty(3, 128, 128)
    kda.kda_chunked(*_blocks(*(x[:65] for x in ops)), s)
    for t in range(65, 70):
        _close(kda.kda_step(s, *(x[t] for x in ops)), want_o[t])


@pytest.mark.parametrize("fault", ["width", "dtype", "layout"])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(fault):
    ops = list(kda.chunk_operands(*_blocks(*_kda_inputs(64))))
    s0 = torch.zeros(3, 128, 128)
    kda.check_kernel_operands(*ops, s0)  # the prefill's own operands pass (u0, w strided)
    if fault == "width":
        ops = list(kda.chunk_operands(*_blocks(*_kda_inputs(64, d=64))))
        s0 = torch.zeros(3, 64, 64)
    elif fault == "dtype":
        ops[0] = ops[0].double()
    else:
        ops[3] = ops[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="float32 operands"):
        kda.check_kernel_operands(*ops, s0)


# ----------------------------------------------------- the configuration
def test_config_reads_the_published_layer_lists_zero_based():
    cfg = K.KimiLinearConfig.from_hf(KIMI)
    assert cfg.kda_layers == tuple(i - 1 for i in KIMI["linear_attn_config"]["kda_layers"])
    assert cfg.mla_layers == (3, 7, 11, 15, 19, 23, 26)
    assert (cfg.n_routed_experts, cfg.experts_held, cfg.first_expert) == (256, 128, 0)
    assert cfg.max_position_embeddings == KIMI["model_max_length"] == 1048576
    assert cfg.num_experts_per_tok == 8 and cfg.routed_scaling_factor == 2.446
    assert cfg.softmax_scale == 192 ** -0.5 and cfg.compute_dtype == torch.bfloat16
    assert not cfg.is_moe(0) and all(cfg.is_moe(i) for i in range(1, 27))


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
    ("num_expert_group", 8), ("num_nextn_predict_layers", 1), ("tie_word_embeddings", True),
    ("torch_dtype", "float16"), ("hidden_act", "gelu"), ("num_key_value_heads", 8)])
def test_config_refuses_what_the_model_does_not_compute(key, value):
    with pytest.raises(ValueError, match=key):
        K.KimiLinearConfig.from_hf({**KIMI, key: value})


def test_config_refuses_layer_lists_that_do_not_cover_the_model():
    lin = {**KIMI["linear_attn_config"], "kda_layers": KIMI["linear_attn_config"]["kda_layers"][1:]}
    with pytest.raises(ValueError, match="linear_attn_config"):
        K.KimiLinearConfig.from_hf({**KIMI, "linear_attn_config": lin})


# ------------------------------------------------------ behind the engine
def _folder(tmp_path, hf):
    (tmp_path / "config.json").write_text(json.dumps(hf))
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + WORDS)
                                        + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("model_type,cls", [("kimi_linear", "KimiLinear"),
                                            ("deepseek_v2", "DeepseekV2")])
def test_native_generator_chooses_the_model_by_model_type(tmp_path, model_type, cls):
    from perfbench.reference.deepseek_v2 import random_weights as ds_weights

    if model_type == "kimi_linear":
        hf, weights = _hf(), R.SeededWeights(_hf(), 0, "cpu")
    else:
        lite = json.loads((REPO / "perfbench/configs/deepseek-v2-lite.rag-flat-bf16.json").read_text())
        hf = {**{k: v for k, v in lite.items() if k not in HARNESS}, "vocab_size": 512,
              "hidden_size": 64, "intermediate_size": 128, "moe_intermediate_size": 32,
              "num_hidden_layers": 3, "num_attention_heads": 4, "n_routed_experts": 8,
              "num_experts_per_tok": 2, "kv_lora_rank": 32, "qk_nope_head_dim": 32,
              "qk_rope_head_dim": 16, "v_head_dim": 32, "torch_dtype": "float32"}
        weights = ds_weights(hf, 0, "cpu")
    gen = AnswerGenerator(_folder(tmp_path, hf), backend="native", max_length=3, device="cpu")
    assert type(gen.native.model).__name__ == cls
    gen.load_state_dict(weights)
    assert len(gen.native.generate_ids([4, 5, 6, 7])) == 3


def test_native_generator_refuses_another_model_type(tmp_path):
    with pytest.raises(ValueError, match="model_type 'llama'"):
        AnswerGenerator(_folder(tmp_path, {**_hf(), "model_type": "llama"}), backend="native",
                        device="cpu")


def test_generator_spans_and_counters(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    gen = AnswerGenerator(_folder(tmp_path, _hf()), backend="native", max_length=4, device="cpu")
    gen.load_state_dict(R.SeededWeights(_hf(), 1, "cpu"))
    native = gen.native
    native.generate_ids(list(range(4, 20)))
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        native.generate_ids(list(range(4, 30)))
    by = {}
    for r in timers.spans():
        by.setdefault(r["name"], []).append(r)
    [prefill], [decode] = by["generator.prefill"], by["generator.decode"]
    c = prefill["counts"]
    assert c["tokens"] == 26 and c["kda_launches"] == 0 and c["attention_launches"] == 0
    assert len(c["expert_tokens"]) == 16 and 0 < sum(c["expert_tokens"]) <= 26 * 8 * 26
    assert "routed_pairs_held" not in c  # the prefill's held pairs are expert_tokens' sum
    assert decode["counts"]["steps"] == 3 and decode["counts"]["context"] == 26
    assert 0 < decode["counts"]["routed_pairs_held"] <= 3 * 8 * 26  # 3 steps' held pairs
    timers.clear()


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 4096, 16896])
def test_state_pass_kernel_matches_its_twin(cuda, n):
    ops = [x.to(cuda) for x in _kda_inputs(n, heads=32, seed=n)]
    w, qp, kh, u0, o0, gamma = kda.chunk_operands(*_blocks(*ops))
    s0 = torch.randn(32, 128, 128, device=cuda) * 0.1
    before = kda.kda_state_pass.launches
    out, last = kda.kda_state_pass(w, qp, kh, u0, o0, gamma, s0)
    assert kda.kda_state_pass.launches - before == 1
    want_out, want_last = kda.kda_state_pass_reference(w, qp, kh, u0, o0, gamma, s0)
    assert (out - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (last - want_last).abs().max() <= 1e-4 * want_last.abs().max()


@pytest.mark.cuda
def test_state_pass_kernel_writes_its_state_in_place(cuda):
    ops = [x.to(cuda) for x in _kda_inputs(130, heads=32)]
    s = torch.full((32, 128, 128), 7.0, device=cuda)
    o = kda.kda_chunked(*_blocks(*ops), s)[:130]  # zeroes s; the kernel writes the last state
    want_o, want_s = R.kda_recurrent(*(x.double() for x in ops))
    assert (o.double() - want_o).abs().max() <= 1e-5 * want_o.abs().max()
    assert (s.double() - want_s).abs().max() <= 1e-5 * want_s.abs().max()


@pytest.mark.cuda
def test_card_prefill_launches_the_kernel_once_a_kda_layer(cuda):
    """The model at the kernels' widths (KDA heads of 128; MLA's 128 + 64 and
    128) and a few layers: one state pass a KDA layer, one attention kernel
    an MLA layer; the decode kernel launched from the host once a KDA layer
    in the first step and once more at the graph's capture."""
    lin = {**KIMI["linear_attn_config"], "kda_layers": [1, 2, 3], "full_attn_layers": [4],
           "num_heads": 2}
    hf = {**KIMI, "vocab_size": 512, "hidden_size": 256, "intermediate_size": 256,
          "moe_intermediate_size": 64, "num_hidden_layers": 4, "num_attention_heads": 2,
          "num_key_value_heads": 2, "linear_attn_config": lin, "num_experts": 16}
    m = K.KimiLinear(K.KimiLinearConfig.from_hf(hf), cuda)
    m.load_state_dict(R.SeededWeights(hf, 0, cuda))
    m.reserve(300)
    logits = m.prefill(_ids(300).to(cuda))
    c = m.prefill_counts()
    assert c["kda_launches"] == 3 and c["attention_launches"] == 1
    assert bool(torch.isfinite(logits).all())
    launched = kda.kda_decode_step.launches
    for p in range(300, 303):  # the decode graph on the kept states
        assert bool(torch.isfinite(m.decode(_ids(1, p).to(cuda), p)).all())
    assert kda.kda_decode_step.launches - launched == 2 * 3  # replays launch it uncounted


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 32])
def test_decode_kernel_matches_its_twin(cuda, heads):
    """One decode step at the kernel's widths (K = V = 128): the kernel
    against its plain twin on the same operands. The state is float32 on
    both sides (sums in other orders: 1e-5 of its largest); the output is
    rounded to bf16 on both, so a value may differ by one bf16 step (2^-8
    of itself; held to 2^-7 of the largest)."""
    g = torch.Generator().manual_seed(heads)
    width = 3 * heads * 128

    def rand(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale + shift).to(dtype).to(cuda)

    ops = [rand(4, width, dtype=torch.bfloat16), rand(4, width, scale=0.5),
           -F.softplus(rand(heads, 128, shift=-3.0)), rand(1, heads * 128, dtype=torch.bfloat16),
           rand(1, heads, dtype=torch.bfloat16), rand(128, scale=0.02, shift=1.0)]
    state = rand(heads, 128, 128, scale=0.1)
    s_kernel, s_twin = state.clone(), state.clone()
    before = kda.kda_decode_step.launches
    out = kda.kda_decode_step(*ops, s_kernel, 1e-5)
    assert kda.kda_decode_step.launches - before == 1
    want = kda.kda_decode_step_reference(*ops, s_twin, 1e-5)
    assert out.dtype == want.dtype == torch.bfloat16 and out.shape == want.shape
    assert (out.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    assert (s_kernel - s_twin).abs().max() <= 1e-5 * s_twin.abs().max()
    assert (s_kernel - state).abs().max() > 0.01 * state.abs().max()  # the step moved it


@pytest.mark.parametrize("fault", ["width", "dtype", "layout"])
def test_decode_kernel_checks_refuse_what_the_kernel_does_not_take(fault):
    heads, d = 2, 128

    def ops(d):
        width = 3 * heads * d
        return [torch.zeros(4, width, dtype=torch.bfloat16), torch.zeros(4, width),
                torch.zeros(heads, d), torch.zeros(1, heads * d, dtype=torch.bfloat16),
                torch.zeros(1, heads, dtype=torch.bfloat16), torch.ones(d),
                torch.zeros(heads, d, d)]

    good = ops(d)
    kda.check_decode_operands(*good)  # the model's own operands pass
    if fault == "width":
        good = ops(64)
    elif fault == "dtype":
        good[2] = good[2].double()  # the decay in float64
    else:
        good[6] = good[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="decode kernel"):
        kda.check_decode_operands(*good)
