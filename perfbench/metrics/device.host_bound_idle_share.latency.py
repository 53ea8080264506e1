"""Share of the traced window a card is idle while the host is not waiting for it in a *.to_host span, mean over the cell's cards."""

from perfbench import program_spans as P

UNIT = "%"


def read(ctx):
    return P.host_bound_idle_share(ctx)
