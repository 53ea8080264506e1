"""Set-up: process start to the window's start (host clock)."""

UNIT = "s"


def read(ctx):
    return ctx['setup_s']
