"""radio.device_idle: the card's idle share of the profiled slice, %: 1 -
the union of its kernel, memcpy and memset intervals over the slice's
wall time. Moves piece_latency_p95_ms."""

from yardstick import readers


def read(ctx):
    return readers.idle_share(ctx)
