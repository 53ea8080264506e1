"""Rows made searchable (embedded, stored, indexed) in the window over its time."""

UNIT = "rows/s"


def read(ctx):
    r = ctx['rec']['done'].get('rows')
    return r / ctx['window_s'] if r else None
