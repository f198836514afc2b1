"""wlan.k2_roofline: K2's share of its roofline in the WLAN cell, %: the
frozen viterbi_bound over the trellis steps that the traffic's frames in
the slice's runs need (a 24-step SIGNAL and a SERVICE + PSDU + tail
payload trellis a frame, each at its own length, not the padded slots),
divided by viterbi_kernel's device time in the profiled slice. Moves
rx_msamples_per_s."""

from yardstick import readers

KERNELS = ("viterbi_kernel",)


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, readers.k2_bound)
