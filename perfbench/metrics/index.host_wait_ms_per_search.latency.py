"""Host time of VectorStore.search's copy of its answers to the host (where the host waits for the cards) a search, from the port's vector_store.to_host spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_search(ctx, 'vector_store.to_host')
