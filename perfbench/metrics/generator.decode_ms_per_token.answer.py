"""Host time of the generator's decode loops over their steps, in ms a token, from the port's generator.decode spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    recs = [r for r in P.records(ctx) or [] if r["name"] == "generator.decode"]
    steps = sum(r["counts"]["steps"] for r in recs)
    return sum(r["t1_ns"] - r["t0_ns"] for r in recs) / steps / 1e6 if steps else None
