"""radio.k1_roofline: K1's share of its roofline, %: the frozen
sync_detect_bound (yardstick/roofline.py) over the samples of each
group's channel stream in the slice's batches (one row, 2 slots a
frame), divided by the device time of the detector's kernels in the
profiled slice. Moves piece_latency_p95_ms."""

from yardstick import readers

KERNELS = ("sync_detect_kernel", "sync_merge_kernel")


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, readers.k1_bound)
