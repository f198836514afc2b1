"""radio.k2_roofline: K2's share of its roofline, %: the frozen
viterbi_bound over the trellis steps that the pieces' MPDUs in the
slice's batches need (a 24-step SIGNAL and a SERVICE + PSDU + tail
payload trellis a frame, not the padded slots), divided by
viterbi_kernel's device time in the profiled slice.
Moves piece_latency_p95_ms."""

from yardstick import readers

KERNELS = ("viterbi_kernel",)


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, readers.k2_bound)
