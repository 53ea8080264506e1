"""The window's counted operations at the chip's peak over the window's time: the generator's prefills and decode steps (work_dsv2, causal attention at q/k 192 and v 128) at bf16's peak, the query encoder and K1 as mfu.latency counts them."""

from perfbench import program_spans as P
from perfbench import work, work_dsv2 as W
from perfbench.traffic.rag_answer import generator_config

UNIT = "%"


def read(ctx):
    recs, dev = P.records(ctx), ctx.get("device")
    if recs is None or dev is None or "encoder_lengths" not in ctx:
        return None
    cfg = generator_config(ctx["config"])
    gen = 0.0
    for r in recs:
        if r["name"] == "generator.generate":
            n, new = r["counts"]["prompt_tokens"], r["counts"]["new_tokens"]
            gen += W.prefill_flops(n, cfg) + sum(W.decode_flops(n + j, cfg) for j in range(new - 1))
    least = gen / work.PEAK_FLOPS[cfg.get("torch_dtype", "bfloat16")]
    least += work.encoder_flops(ctx["encoder_lengths"], ctx["model"]) / work.PEAK_FLOPS[
        ctx["config"]["encoder"]["dtype"]]
    least += sum(w["flops"] / work.PEAK_FLOPS[w["dtype"]] for call in ctx["search_work"]
                 for _, w in call)
    cards = len(dev["busy_s"])
    return 100.0 * least / (ctx["window_s"] * cards) if gen > 0 else None
