"""Host time of the sharded search's per-shard passes (the query's copy and K1's launch on each card) summed a search, from the port's sharded.shard_scan spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_search(ctx, 'sharded.shard_scan')
