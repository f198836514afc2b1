"""Arithmetic the per-layer readers (metrics/*.py) share: a kernel's
share of its roofline and the device's idle share, from a profiled
slice's reduction (``ctx["profile"]``: kernel seconds by name, busy and
window seconds, and the work the slice held)."""

from __future__ import annotations

from yardstick import roofline


def kernel_share(ctx: dict, kernels: tuple, bound) -> float | None:
    """100 x the bound's time over the named kernels' device time in the
    slice, or None where the slice holds none of them or no work."""
    p = ctx.get("profile")
    if not p or not p.get("work"):
        return None
    seconds = sum(p["kernel_s"].get(k, 0.0) for k in kernels)
    b = bound(p["work"])
    if seconds <= 0.0 or b is None:
        return None
    return 100.0 * roofline.bound_ms(b) / (seconds * 1e3)


def k1_bound(work: dict):
    if not work.get("k1_samples"):
        return None
    return roofline.sync_detect_bound(work["k1_samples"], work["k1_rows"], work["k1_slots"])


def k2_bound(work: dict):
    if not work.get("k2_steps"):
        return None
    return roofline.viterbi_bound(work["k2_steps"])


def idle_share(ctx: dict) -> float | None:
    p = ctx.get("profile")
    if not p or p.get("window_s", 0.0) <= 0.0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
