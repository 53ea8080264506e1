"""95th percentile latency of every request of the window."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.percentile(ctx['rec'].get('latencies_ms'), 95)
