"""K5's bound, a frozen copy of the port's ``ops/track_eq.py``
(``K5_BYTES_PER_ROW``, ``K5_BYTES_PER_STEP``, ``K5_OPS_PER_STEP``,
``track_bound``) over the yardstick's peaks (``roofline``). The program
owns the originals and a kernel change may edit them; the ITS-G5 cell's
``itsg5.track_roofline`` divides by this copy, which no change to the
program moves. The bound takes counts, not tensors.

A frame's 52-carrier LS estimate is read once; a symbol-step reads its
52 used bins and writes 48 equalized symbols and 48 weights; its float32
operations in the kernel's form are counted at the instruction rate.
"""

from __future__ import annotations

from yardstick import roofline

K5_BYTES_PER_ROW = 52 * 8
K5_BYTES_PER_STEP = 52 * 8 + 48 * 8 + 48 * 4
K5_OPS_PER_STEP = 45 + 52 * 77


def track_bound(rows: int, symbols: int) -> dict:
    """K5 over ``rows`` frames holding ``symbols`` symbol-steps in all."""
    return roofline.bound(rows * K5_BYTES_PER_ROW + symbols * K5_BYTES_PER_STEP,
                          symbols * K5_OPS_PER_STEP, roofline.FP32_INSTR_PER_S)
