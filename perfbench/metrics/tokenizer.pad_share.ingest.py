"""Padded positions over all positions of the tokenizer's batches, from the masks it returned."""

from perfbench import readers as R

UNIT = "%"


def read(ctx):
    s = R.spans(ctx, 'tokenizer.encode_batch')
    pos = sum(m['positions'] for _, _, m in s)
    return 100.0 * (1 - sum(sum(m['real']) for _, _, m in s) / pos) if pos else None
