"""The least bytes of the window's Kimi-Linear decode steps (work_kimi.decode_bytes: the shared weights, the head, the 7 MLA layers' latent cache at each step's length, every KDA state read and written, and the held experts' weights once a pair by the decode span's routed_pairs_held) at 3.35 TB/s, over the decode spans' time."""

from perfbench import program_spans as P
from perfbench import work, work_kimi as W
from perfbench.traffic.rag_answer import generator_config

UNIT = "%"


def read(ctx):
    recs = [r for r in P.records(ctx) or [] if r["name"] == "generator.decode"
            and "routed_pairs_held" in r["counts"]]
    cfg = generator_config(ctx["config"])
    least = sum(W.decode_bytes(r["counts"]["context"], r["counts"]["steps"],
                               r["counts"]["routed_pairs_held"], cfg)
                for r in recs) / work.HBM_BYTES_PER_S
    spent = sum(r["t1_ns"] - r["t0_ns"] for r in recs) / 1e9
    return 100.0 * least / spent if spent > 0 and least > 0 else None
