"""Mean host time of QueryEngine.search a call (the query's embedding, K1, the id mapping, SQLite's fetch), from the port's engine.search spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    s = [r["t1_ns"] - r["t0_ns"] for r in P.records(ctx) or [] if r["name"] == "engine.search"]
    return sum(s) / len(s) / 1e6 if s else None
