"""Polyphase FIR rational resampler (L/M) and causal FIR: the port's copy of
the JAX package's ops/resampler.py.

Taps are designed on the host (scipy Kaiser-windowed sinc, cutoff at
min(1/L, 1/M) of the upsampled rate, gain L). ``polyphase_resample`` and
``fir_filter`` run where their input lies: a CUDA tensor through the
hand-written kernels of ops/fir.py (K3, K4), a CPU tensor through their
plain versions. The JAX package's Pallas switch (GWT_PALLAS_FIR) and its
L <= 64 / M <= 96 cut have no counterpart here: the CUDA resampler's
direct form takes any ratio.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops.fir import (  # noqa: F401
    fir_filter,
    polyphase_resample,
)


@functools.cache
def design_lowpass(interp: int, decim: int, taps_per_phase: int = 12,
                   beta: float = 7.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype for L/M resampling.

    Returns float32 taps of length interp * taps_per_phase with gain
    ``interp`` in the passband (compensating the zero-stuffing loss),
    cutoff at min(1/interp, 1/decim) relative to the upsampled rate.
    """
    import scipy.signal as sig

    n_taps = interp * taps_per_phase
    cutoff = min(1.0 / interp, 1.0 / decim)
    taps = sig.firwin(n_taps, cutoff, window=("kaiser", beta))
    return (taps * interp).astype(np.float32)


def rational_resampler(x: torch.Tensor, interp: int, decim: int,
                       taps_per_phase: int = 12) -> torch.Tensor:
    """GNU Radio rational_resampler-style convenience wrapper: reduces L/M
    by their gcd and returns x itself at 1/1."""
    g = math.gcd(interp, decim)
    interp, decim = interp // g, decim // g
    if interp == decim == 1:
        return x
    return polyphase_resample(x, interp, decim, design_lowpass(interp, decim, taps_per_phase))


def correct_sample_clock(x: torch.Tensor, ppm: float,
                         max_denominator: int = 20000) -> torch.Tensor:
    """Undo a TX/RX sample-clock mismatch of ``ppm`` parts-per-million ahead
    of sync: resample by the rational approximation of (1 + ppm*1e-6), so
    sample m lands back on the transmitter's grid."""
    frac = Fraction(1.0 + ppm * 1e-6).limit_denominator(max_denominator)
    if frac.numerator == frac.denominator:
        return x
    return rational_resampler(x, frac.numerator, frac.denominator)
