"""Share of the traced window the card is idle while the host is not waiting for it in a *.to_host span (the generator's copy of each token, the search's of its hits, the encoder's of the query)."""

from perfbench import program_spans as P

UNIT = "%"


def read(ctx):
    return P.host_bound_idle_share(ctx)
