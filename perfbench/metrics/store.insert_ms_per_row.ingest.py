"""Host time of Database.insert_documents a row inserted."""

from perfbench import readers as R

UNIT = "ms"


def read(ctx):
    return R.ms_per(ctx, 'db.insert_documents')
