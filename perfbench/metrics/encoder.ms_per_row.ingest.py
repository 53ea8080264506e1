"""Host time of EmbeddingPipeline.generate_embeddings (tokenizer included) a row embedded."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.ms_per(ctx, 'embedder.generate_embeddings')
