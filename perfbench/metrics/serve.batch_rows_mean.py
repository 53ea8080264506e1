"""Mean rows of the micro-batcher's batches in the window, from the server's /stats counts."""

UNIT = "rows"


def read(ctx):
    b = ctx['rec'].get('batches')
    return sum(n * c for n, c in b.items()) / sum(b.values()) if b else None
