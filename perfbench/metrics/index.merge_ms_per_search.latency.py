"""Host time of the sharded search's merge (the copies between cards, the top-k, the copies home) a search, from the port's sharded.merge spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_search(ctx, 'sharded.merge')
