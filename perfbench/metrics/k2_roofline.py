"""K2 (csrc/union_scan.cu): the least time for the probed rows' work (work.ivf_work) over its device time."""

from perfbench import readers as R

UNIT = "%"


def read(ctx):
    return R.kernel_share(ctx, 'k2')
