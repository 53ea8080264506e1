"""Mean host time of VectorStore.search a call (the scan, the id mapping, the host copy)."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.mean_ms(ctx, 'vector_store.search')
