"""itsg5.track_roofline: K5's share of its roofline, %: the frozen
track_bound (yardstick/track_roofline.py) over the tracking the traffic's
frames in the slice's runs need (stage A's SIGNAL symbol and stage B's
SIGNAL and data symbols a frame, not the padded rows or empty slots),
divided by track_eq_kernel's device time in the profiled slice. Nothing
where the slice holds no such kernel. Moves rx_msamples_per_s."""

from yardstick import readers, track_roofline

KERNELS = ("track_eq_kernel",)


def _bound(work: dict):
    if not work.get("track_steps"):
        return None
    return track_roofline.track_bound(work["track_rows"], work["track_steps"])


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, _bound)
