"""mfu.answer for the Kimi-Linear generator: the window's counted operations at the chip's peak over the window's time. The prefills and decode steps (work_kimi: the shared weights, the routed pairs this card's experts took by the prefill span's expert_tokens and the decode span's routed_pairs_held, causal MLA at q/k 192 and v 128 in 7 layers, KDA's chunked form and decode step) at bf16's peak; the query encoder and K1 as mfu.latency counts them."""

from perfbench import program_spans as P
from perfbench import work, work_kimi as W
from perfbench.traffic.rag_answer import generator_config

UNIT = "%"


def read(ctx):
    recs, dev = P.records(ctx), ctx.get("device")
    if recs is None or dev is None or "encoder_lengths" not in ctx:
        return None
    cfg = generator_config(ctx["config"])
    gen = 0.0
    for r in recs:
        c = r["counts"]
        if r["name"] == "generator.prefill" and "kda_launches" in c:
            gen += W.prefill_flops(c["tokens"], sum(c["expert_tokens"]), cfg)
        elif r["name"] == "generator.decode" and "routed_pairs_held" in c:
            gen += W.decode_flops(c["context"], c["steps"], c["routed_pairs_held"], cfg)
    least = gen / work.PEAK_FLOPS[cfg.get("torch_dtype", "bfloat16")]
    least += work.encoder_flops(ctx["encoder_lengths"], ctx["model"]) / work.PEAK_FLOPS[
        ctx["config"]["encoder"]["dtype"]]
    least += sum(w["flops"] / work.PEAK_FLOPS[w["dtype"]] for call in ctx["search_work"]
                 for _, w in call)
    cards = len(dev["busy_s"])
    return 100.0 * least / (ctx["window_s"] * cards) if gen > 0 else None
