"""The window's counted operations at the chip's peak over the window's time."""

from perfbench import readers as R

UNIT = "%"


def read(ctx):
    return R.mfu(ctx)
