"""Device operations (kernels, copies, sets) in the traced window over the searches made in it."""

from perfbench import readers as R

UNIT = "ops"


def read(ctx):
    dev, s = ctx.get('device'), R.spans(ctx, 'vector_store.search')
    return len(dev['events']) / len(s) if dev and s else None
