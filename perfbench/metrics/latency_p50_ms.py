"""Median latency of every request of the window, each timed from its due time (open loop) or its call (closed loop) to its answer."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.percentile(ctx['rec'].get('latencies_ms'), 50)
