"""The card's peaks that every kernel's bound divides by.

Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's H100
data sheet, dense rates): 3.35 TB/s of HBM3, and 67 TFLOP/s in float32
outside the tensor cores, a rate that counts each fused multiply-add as
two operations (132 SMs x 128 float32 lanes x 1.98 GHz x 2). An
instruction that is not an FMA (an add, a compare, a max) retires one a
lane a cycle, so work counted in such instructions meets half that rate.

A kernel's bound is the least time the card could take for its work: the
bytes it must move (each input read once, each output written once) over
the memory rate, and its operations over the rate of their kind; the
larger of the two bounds it. Each kernel module reckons its own
(``sync_stats_bound``, ``sync_detect_bound``, ``viterbi_bound``,
``fir_bound``, ``resample_bound``) from the shapes of the work alone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FMA_OPS_PER_S = 67e12          # an FMA counted as two operations
FP32_INSTR_PER_S = 33.5e12          # adds, compares, maxes: one a lane a cycle


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """{"bytes": ms, "operations": ms}: n_bytes over the memory rate and
    n_ops over ``ops_per_s``."""
    return {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": n_ops / ops_per_s * 1e3}


def bound_str(b: dict) -> str:
    """'<ms> ms by <bytes|operations>', the larger of the two."""
    by = max(b, key=b.get)
    return f"{b[by]:.5f} ms by {by}"
