"""Share of the traced window the card is idle while the host is not waiting for it in a *.to_host span (the encoder's copy of each batch)."""

from perfbench import program_spans as P

UNIT = "%"


def read(ctx):
    return P.host_bound_idle_share(ctx)
