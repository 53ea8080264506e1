"""Host time of the tokenizer's encode_batch a row, from the port's encoder.tokenize spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_row(ctx, 'encoder.tokenize')
