"""The RAG answer cell's whole run on the CPU at a small size: a sound run
reads correct, the fp8 control and the planted faults do not. The
generator keeps DeepSeek-V2-Lite's depth (27 layers), routing (64
experts, 6 a token, 2 shared) and precision (bf16) at small widths."""

import dataclasses

import pytest

from rag_faiss_embedding_tpu_torch.models import deepseek_v2

CELL = "dsv2lite.rag-answer-16k"
# the window has to hold both checked calls (the first two) on a busy host
WINDOW_S = 8.0
SMALL = {
    "config": {
        "vocab_size": 32768, "hidden_size": 64, "intermediate_size": 128,
        "moe_intermediate_size": 16, "num_attention_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
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
    """The port's spans record under a profiler: on the card the device
    trace's; here a CPU one around the run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        r = run_cell(CELL, overrides=SMALL, seconds=WINDOW_S, trace=True)
    m = r["metrics"]
    for name in ("generator.prefill_ms_per_call.answer", "generator.decode_ms_per_token.answer",
                 "generator.decode_roofline.answer", "engine.search_ms_per_call.answer"):
        assert m[name]["value"] > 0, name
    assert r["correct"], r["checks"]


def test_control_is_not_correct(run_cell):
    r = run_cell(CELL, overrides=SMALL, control="fp8")
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_rel_median"]["value"] > r["checks"]["logit_rel_median"]["limit"]
    assert r["checks"]["dist_rel"]["value"] <= r["checks"]["dist_rel"]["limit"]


def _no_shared_expert(monkeypatch):
    real = deepseek_v2.DeepseekV2._moe

    def moe(self, i, x32, count):
        saved = self.layers[i].gate_up
        self.layers[i].gate_up = None
        try:
            return real(self, i, x32, count)
        finally:
            self.layers[i].gate_up = saved

    monkeypatch.setattr(deepseek_v2.DeepseekV2, "_moe", moe)


def _top_k_less_one(monkeypatch):
    """The router keeps one expert fewer than the configuration's (top-5)."""
    real = deepseek_v2.DeepseekV2._moe

    def moe(self, i, x32, count):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1)
        try:
            return real(self, i, x32, count)
        finally:
            self.cfg = cfg

    monkeypatch.setattr(deepseek_v2.DeepseekV2, "_moe", moe)


def _no_mscale(monkeypatch):
    monkeypatch.setattr(deepseek_v2.DeepseekV2Config, "softmax_scale", property(
        lambda self: self.qk_head_dim ** -0.5))


def _k_pe_not_roped(monkeypatch):
    """The shared rope key goes into the cache unrotated (it is the last
    group ``apply_rope`` is given; the queries' are rotated)."""
    real = deepseek_v2.apply_rope

    def rope(x, f):
        out = real(x, f)
        out[..., -1, :] = x[..., -1, :].float()
        return out

    monkeypatch.setattr(deepseek_v2, "apply_rope", rope)


def _stale_decode_row(monkeypatch):
    """A decode step's row never reaches the cache: the step reads the row
    a former call left at its position."""
    real = deepseek_v2.DeepseekV2._latent

    def latent(self, i, x, factors):
        q_nope, q_pe, rows = real(self, i, x, factors)
        if rows.shape[0] == 1:  # a decode step: keep the row that is there
            rows = self.cache[i].index_select(0, self._step["pos"])
        return q_nope, q_pe, rows

    monkeypatch.setattr(deepseek_v2.DeepseekV2, "_latent", latent)


def _chunk_dropped(monkeypatch):
    """The engine writes its prompt from all but the last chunk."""
    from rag_faiss_embedding_tpu_torch.rag.engine import QueryEngine

    real = QueryEngine.generate_response
    monkeypatch.setattr(QueryEngine, "generate_response",
                        lambda self, q, docs: real(self, q, docs[:-1]))


def _context_budget_halved(monkeypatch):
    """Each chunk cut to half its share of the context budget."""
    from rag_faiss_embedding_tpu_torch.rag.engine import QueryEngine

    real = QueryEngine.truncate_content
    monkeypatch.setattr(QueryEngine, "truncate_content",
                        lambda self, text, n: real(self, text, max(1, n // 2)))


FAULTS = [_no_shared_expert, _top_k_less_one, _no_mscale, _k_pe_not_roped, _stale_decode_row,
          _chunk_dropped, _context_budget_halved]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_planted_fault_is_not_correct(run_cell, monkeypatch, fault):
    fault(monkeypatch)
    r = run_cell(CELL, overrides=SMALL, seconds=WINDOW_S)
    assert not r["correct"], r["checks"]
    assert r["checks"]["missing"]["value"] == 0  # every call answered: the logits tell
    print(fault.__name__, {k: r["checks"][k]["value"]
                           for k in ("logit_rel_median", "prompt_mismatch")})
