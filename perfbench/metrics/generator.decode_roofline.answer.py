"""The least bytes of the window's decode steps (active weights, head and the latent cache at each step's length, work_dsv2.decode_bytes) at 3.35 TB/s, over the decode spans' time."""

from perfbench import program_spans as P
from perfbench import work, work_dsv2 as W
from perfbench.traffic.rag_answer import generator_config

UNIT = "%"


def read(ctx):
    recs = [r for r in P.records(ctx) or [] if r["name"] == "generator.decode"]
    cfg = generator_config(ctx["config"])
    least = sum(W.decode_bytes(r["counts"]["context"] + j, cfg)
                for r in recs for j in range(r["counts"]["steps"])) / work.HBM_BYTES_PER_S
    spent = sum(r["t1_ns"] - r["t0_ns"] for r in recs) / 1e9
    return 100.0 * least / spent if spent > 0 and least > 0 else None
