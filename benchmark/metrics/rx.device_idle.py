"""rx.device_idle: the card's idle share of the profiled slice, %: 1 -
the union of its kernel, memcpy and memset intervals over the slice's
wall time. Moves rx_msamples_per_s."""

from yardstick import readers


def read(ctx):
    return readers.idle_share(ctx)
