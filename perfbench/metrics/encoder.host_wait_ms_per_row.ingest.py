"""Host time of the encoder's copy of each batch to the host (where the host waits for the card) a row, from the port's encoder.to_host spans."""

from perfbench import program_spans as P

UNIT = "ms"


def read(ctx):
    return P.ms_per_row(ctx, 'encoder.to_host')
