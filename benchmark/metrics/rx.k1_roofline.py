"""rx.k1_roofline: K1's share of its roofline, %: the frozen
sync_detect_bound (yardstick/roofline.py) over the samples the traffic
holds (each read once) in the slice's runs, the rows the executor cuts
them into and their slots, divided by the device time of the detector's
kernels in the profiled slice. Moves rx_msamples_per_s."""

from yardstick import readers

KERNELS = ("sync_detect_kernel", "sync_merge_kernel")


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, readers.k1_bound)
