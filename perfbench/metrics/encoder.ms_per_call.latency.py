"""Mean host time of EmbeddingPipeline.generate_embeddings (tokenizer included) a call."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.mean_ms(ctx, 'embedder.generate_embeddings')
