"""How far apart the cards start their scans in a sharded search: in each root vector_store.search span, the first stage-1 K1 event on each card, the latest card's start minus the earliest, in ms; the mean over the searches that ran K1 on two or more cards. From the device trace, on the port's spans' clock."""

from bisect import bisect_left

from perfbench import program_spans as P
from perfbench import work

UNIT = "ms"
STAGE1 = tuple(n for n in work.KERNELS["k1"] if n.startswith("scan_"))


def read(ctx):
    recs, dev = P.records(ctx), ctx.get("device")
    if recs is None or dev is None:
        return None
    k1 = sorted((a, card) for name, card, a, _ in dev["events"]
                if any(s in name for s in STAGE1))
    starts = [a for a, _ in k1]
    spreads = []
    for r in recs:
        if r["name"] != "vector_store.search" or r["parent"] is not None:
            continue
        first = {}
        for a, card in k1[bisect_left(starts, r["t0_ns"]):bisect_left(starts, r["t1_ns"])]:
            first.setdefault(card, a)
        if len(first) > 1:
            spreads.append(max(first.values()) - min(first.values()))
    return sum(spreads) / len(spreads) / 1e6 if spreads else None
