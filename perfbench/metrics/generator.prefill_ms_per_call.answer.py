"""Mean host time of the generator's prefill a call (the prompt's forward through the latent cache and its first token's copy to the host), from the port's generator.prefill spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    recs = P.records(ctx)
    s = [r["t1_ns"] - r["t0_ns"] for r in recs or [] if r["name"] == "generator.prefill"]
    return sum(s) / len(s) / 1e6 if s else None
