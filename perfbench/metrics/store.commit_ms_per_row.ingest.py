"""Host time of SQLite's commit a row inserted, from the port's store.commit spans over the rows of their store.insert."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_parent_row(ctx, 'store.commit')
