"""Mean host time of Database.get_documents_by_ids a call (one a query of a batch)."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.mean_ms(ctx, 'db.get_documents_by_ids')
