"""The Kimi-Linear answer cell's whole run on the CPU at a small size: a sound
run reads correct, the fp8 control and the planted faults do not. The
generator keeps Kimi-Linear-48B-A3B's depth and layer pattern (27 layers:
20 KDA, 7 MLA at 1-based 4, 8, ..., 24, 27), its routing (sigmoid, 8 a
token, renormalised, times 2.446, one shared expert), the expert share
(half the experts held, expert parallel 2) and its precision (bf16), at
small widths."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import kimi_linear as R
from rag_faiss_embedding_tpu_torch.models import kimi_linear as K
from rag_faiss_embedding_tpu_torch.ops import kda

CELL = "kimilinear.rag-answer-16k"
WINDOW_S = 8.0  # the window has to hold both checked calls (the first two) on a busy host
SMALL = {
    "config": {
        "vocab_size": 32768, "hidden_size": 64, "intermediate_size": 128,
        "moe_intermediate_size": 16, "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
        "linear_attn_config": {"num_heads": 2, "head_dim": 32}, "num_experts": 16,
        "rows": {"n": 8192, "modes": 64}, "corpus": {"documents": 8192, "words": [60, 90]},
        "port": {"top_k": 4, "context_token_budget": 160, "generation_max_length": 6}},
    "cell": {"params": {"questions": 6, "top_k": 4, "check_calls": 2, "check_within": 2}},
}


def test_sound_run_is_correct(run_cell):
    r = run_cell(CELL, overrides=SMALL, seconds=WINDOW_S)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["logit_rel_median"]["value"] > 0
    assert r["checks"]["prompt_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}


def test_traced_run_reports_the_generator(run_cell):
    """The port's spans record under a profiler (a CPU one here); the
    readers of the device trace have nothing to read on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        r = run_cell(CELL, overrides=SMALL, seconds=WINDOW_S, trace=True)
    m = r["metrics"]
    for name in ("generator.prefill_ms_per_call.answer", "generator.decode_ms_per_token.answer",
                 "generator.decode_roofline.answer_kimi", "engine.search_ms_per_call.answer"):
        assert m[name]["value"] > 0, name
    assert "kda_scan_roofline" not in m and "mfu.answer_kimi" not in m
    assert r["correct"], r["checks"]


def test_control_is_not_correct(run_cell):
    r = run_cell(CELL, overrides=SMALL, control="fp8")
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_rel_median"]["value"] > r["checks"]["logit_rel_median"]["limit"]
    assert r["checks"]["dist_rel"]["value"] <= r["checks"]["dist_rel"]["limit"]


def _after_prefill(monkeypatch, change):
    real = K.KimiLinear.prefill

    def prefill(self, ids):
        logits = real(self, ids)
        change(self)
        return logits

    monkeypatch.setattr(K.KimiLinear, "prefill", prefill)


def _zero_kda_state(monkeypatch):
    """Decode starts from a zeroed KDA state: the prefill's is dropped."""
    _after_prefill(monkeypatch, lambda m: m._kda_state.zero_())


def _conv_tails_dropped(monkeypatch):
    """The convolutions' last inputs are not carried from prefill to decode."""
    _after_prefill(monkeypatch, lambda m: m._conv_tail.zero_())


def _decay_per_head(monkeypatch):
    """One scalar decay a head (Gated DeltaNet's) in place of one a key
    channel: each head's channels take their mean."""
    real = K.KimiLinear._decay

    def decay(self, i, f):
        g = real(self, i, f)
        return g.mean(-1, keepdim=True).expand_as(g).contiguous()

    monkeypatch.setattr(K.KimiLinear, "_decay", decay)


def _no_delta(monkeypatch):
    """The state takes ``beta k v^T`` with no delta correction (``S^T k`` not
    taken off ``v``), in prefill and decode alike."""
    def step(s, q, k, v, g, beta):
        s.mul_(g.exp()[..., None]).add_((beta[:, None] * k)[..., None] * v[:, None])
        return (q[:, None] @ s)[:, 0]

    def chunked(q, k, v, g, beta, s_out):  # the chunked layout [heads, chunks, 64, width]
        s_out.zero_()
        rows = [x.flatten(1, 2).transpose(0, 1) for x in (q, k, v, g, beta)]
        return torch.stack([step(s_out, *(x[t] for x in rows[:4]), rows[4][t, :, 0])
                            for t in range(rows[0].shape[0])])

    # decode through the plain twin (on the card too), its recurrence step replaced
    monkeypatch.setattr(kda, "kda_step", step)
    monkeypatch.setattr(K, "kda_decode_step", kda.kda_decode_step_reference)
    monkeypatch.setattr(K, "kda_chunked", chunked)


def _softmax_router(monkeypatch):
    """The router's scores are a softmax over the experts, not sigmoids
    (``KimiLinear._moe`` with that one change)."""
    def moe(self, i, x32, count):
        cfg, layer = self.cfg, self.layers[i]
        scores = F.linear(x32, layer.router).softmax(-1)
        expert = torch.topk(scores + self._score_bias[i], cfg.num_experts_per_tok, -1).indices
        weight = scores.gather(1, expert)
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
        x = x32.to(self.dtype)
        out = K._routed(layer, x, weight, expert, cfg.n_routed_experts)
        return out + K._swiglu(x, layer.gate_up, layer.down)

    monkeypatch.setattr(K.KimiLinear, "_moe", moe)


def _no_scale(monkeypatch):
    """The chosen weights are not scaled by routed_scaling_factor."""
    real = K.KimiLinear._moe

    def moe(self, i, x32, count):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, routed_scaling_factor=1.0)
        try:
            return real(self, i, x32, count)
        finally:
            self.cfg = cfg

    monkeypatch.setattr(K.KimiLinear, "_moe", moe)


def _all_experts(monkeypatch):
    """The program computes every expert of each layer, not the half this
    card holds: it is given the uncut layers, the reference the share."""
    real_cfg, real_load = K.KimiLinearConfig.from_hf.__func__, K.KimiLinear.load_state_dict

    def whole(hf):
        return {**hf, "num_experts": hf["num_experts"] * hf.get("expert_parallel", 1),
                "expert_parallel": 1}

    monkeypatch.setattr(K.KimiLinearConfig, "from_hf",
                        classmethod(lambda cls, hf: real_cfg(cls, whole(hf))))
    monkeypatch.setattr(K.KimiLinear, "load_state_dict", lambda self, sd: real_load(
        self, R.random_weights(whole(sd.cfg), sd.seed, sd.device)))


FAULTS = [_zero_kda_state, _conv_tails_dropped, _decay_per_head, _no_delta, _softmax_router,
          _no_scale, _all_experts]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_planted_fault_is_not_correct(run_cell, monkeypatch, fault):
    fault(monkeypatch)
    r = run_cell(CELL, overrides=SMALL, seconds=WINDOW_S)
    assert not r["correct"], r["checks"]
    assert r["checks"]["missing"]["value"] == 0  # every call answered: the logits tell
    print(fault.__name__, r["checks"]["logit_rel_median"]["value"])
