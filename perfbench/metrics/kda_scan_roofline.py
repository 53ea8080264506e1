"""The KDA state pass kernel's least time (work_kimi.kda_scan_work: its bytes at 3.35 TB/s or its products at bf16's 989 TFLOP/s, whichever is larger) for its launches in the window's prefills (the generator.prefill spans' tokens and kda_launches), over its device time found by kernel name."""

from perfbench import program_spans as P
from perfbench import work, work_kimi as W
from perfbench.traffic.rag_answer import generator_config

UNIT = "%"
KERNEL = "kda_state_pass_kernel"  # csrc/kda_state_pass.cu


def read(ctx):
    recs, dev = P.records(ctx), ctx.get("device")
    if recs is None or dev is None:
        return None
    cfg = generator_config(ctx["config"])
    least = sum(work.work_bound(W.kda_scan_work(r["counts"]["tokens"], cfg))
                * r["counts"]["kda_launches"]
                for r in recs if r["name"] == "generator.prefill" and "kda_launches" in r["counts"])
    spent = sum(b - a for n, _, a, b in dev["events"] if KERNEL in n) / 1e9
    return 100.0 * least / spent if spent > 0 and least > 0 else None
