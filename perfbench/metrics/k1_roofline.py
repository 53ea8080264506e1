"""K1 (csrc/flat_scan.cu): the least time for its launches' work (work.flat_work) over its device time."""

from perfbench import readers as R

UNIT = "%"


def read(ctx):
    return R.kernel_share(ctx, 'k1')
