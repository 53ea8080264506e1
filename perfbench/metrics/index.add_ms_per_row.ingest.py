"""Host time of VectorStore.add_vectors a row added."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.ms_per(ctx, 'vector_store.add_vectors')
