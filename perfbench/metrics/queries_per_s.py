"""Queries answered in the window over the window's time."""

UNIT = "queries/s"


def read(ctx):
    q = ctx['rec']['done'].get('queries')
    return q / ctx['window_s'] if q else None
