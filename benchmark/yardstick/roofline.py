"""The yardstick's peaks and kernel bounds, a frozen copy.

Copied at commit 10b5b06 from the port's ``ops/roofline.py`` (the peaks),
``ops/sync_stats.py`` (``K1_OPS_PER_SAMPLE``, ``K1_DETECT_OPS_PER_SAMPLE``,
``sync_detect_bound``) and ``ops/viterbi_acs.py`` (``K2_OPS_PER_STEP``,
``K2_ACS_CYCLES``, ``K2_TRACEBACK_CYCLES``, ``viterbi_bound``,
``chain_floor_ms``). The program owns the originals and a kernel change
may edit them; the benchmark's roofline shares divide by these, which no
change to the program moves. The bounds take counts, not tensors.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates): 3.35 TB/s of HBM3; 67 TFLOP/s in float32 outside the tensor
cores with an FMA counted as two operations (132 SMs x 128 lanes x 1.98
GHz x 2), so an add, compare or max retires at half that rate. A bound is
the larger of the bytes the work must move (each input read once, each
output written once) over the memory rate and its operations over the
rate of their kind.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FMA_OPS_PER_S = 67e12          # an FMA counted as two operations
FP32_INSTR_PER_S = 33.5e12          # adds, compares, maxes: one a lane a cycle

# K1: float32 operations a sample of the sync statistics in the kernels'
# addition-only form (m 6, |x|^2 3, the window sums of 8 outputs 226, |a|/p
# 5); the fused detector adds the threshold compare
K1_OPS_PER_SAMPLE = 6 + 3 + 226 / 8 + 5
K1_DETECT_OPS_PER_SAMPLE = K1_OPS_PER_SAMPLE + 1

# K2: a frame's trellis step in the kernel's form: 4 gains x (2 mul + 1
# add) + 64 states x 2 edges x 1 add + 64 compare/select + 63 max + 64
# subtract; and the design's dependent cycles a step (ACS, traceback)
K2_OPS_PER_STEP = 4 * 3 + 64 * 2 + 64 + 63 + 64
K2_ACS_CYCLES = 165
K2_TRACEBACK_CYCLES = 45


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """{"bytes": ms, "operations": ms}."""
    return {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": n_ops / ops_per_s * 1e3}


def bound_ms(b: dict) -> float:
    """The larger of a bound's two times, the least the card could take."""
    return max(b.values())


def sync_detect_bound(samples: int, rows: int, k: int) -> dict:
    """The fused detector over ``samples`` complex64 samples in ``rows``
    rows with ``k`` slots a row: each sample read once, each slot's start,
    valid, cfo and ratio written once; the statistics and the threshold
    compare on every sample."""
    return bound(samples * 8 + rows * k * (4 + 1 + 8 + 4),
                 samples * K1_DETECT_OPS_PER_SAMPLE, FP32_INSTR_PER_S)


def viterbi_bound(steps: int) -> dict:
    """K2 over ``steps`` trellis steps in all (frames x steps): an LLR pair
    read and a decided bit written a step, the ACS of a step."""
    return bound(steps * (8 + 1), steps * K2_OPS_PER_STEP, FP32_INSTR_PER_S)


def chain_floor_ms(steps: int, sm_mhz: float) -> float:
    """The K2 design's floor for one trellis of ``steps`` steps at an SM
    clock of ``sm_mhz``: ACS and traceback steps one after the other."""
    return steps * (K2_ACS_CYCLES + K2_TRACEBACK_CYCLES) / (sm_mhz * 1e3)
