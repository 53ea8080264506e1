"""Share of the traced window with no operation on the card."""

from perfbench import readers as R

UNIT = "%"


def read(ctx):
    return R.idle_share(ctx)
