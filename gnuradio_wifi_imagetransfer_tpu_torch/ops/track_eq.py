"""LMS/STA tracking equalizer (K5): the CUDA kernel's wrapper and bounds.

The kernel is ``csrc/track_eq.cu``: one launch runs a batch of frames'
whole LMS or STA recursion over their OFDM symbols, one warp a frame, the
estimate in registers. It replaces no TPU kernel (the JAX package leaves
the recursion to a ``lax.scan``); its plain version is the loop in
``phy/equalizer.py``, which ``equalize`` runs for CPU tensors and which
this kernel must agree with within float32 tolerances (same operations,
another rounding: the loop's torch ops may contract, the kernel may not).

``track_bound`` is the kernel's bound and ``chain_floor_ms`` the floor of
its design's serial chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.ops import build, roofline
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params

# the kernel's decisions (csrc/track_eq.cu Decide)
PROXY, BPSK, QAM = 0, 1, 2


@functools.cache
def decision_args(mcs: int | None) -> tuple[int, int, tuple, tuple]:
    """(decision, per-axis levels, their amplitudes in point-index order,
    the two BPSK points) of ``mcs``'s constellation, from
    ``params.constellation`` (None: the unit-modulus proxy). A square QAM
    point v is (level[v >> h], level[v & (2^h - 1)]) with h bits an axis,
    so the nearest point with ties to the first index is the nearest level
    on each axis with ties to the first."""
    bpsk = tuple(float(v) for v in params.constellation(1).real)
    if mcs is None:
        return PROXY, 2, (), bpsk
    n_bpsc = int(params.MCS_N_BPSC[mcs])
    if n_bpsc == 1:
        return BPSK, 2, (), bpsk
    half = n_bpsc // 2
    pts = params.constellation(n_bpsc)
    level = tuple(float(pts[i << half].real) for i in range(1 << half))
    return QAM, len(level), level, bpsk


def track_eq(sym_freq: torch.Tensor, h0: torch.Tensor, pol: torch.Tensor,
             algo: ChannelEstimator, mcs: int | None, sig_first: bool,
             lms_mu: float, sta_alpha: float, sta_beta: float):
    """The LMS or STA recursion of ``phy.equalizer.equalize`` over CUDA
    tensors in one launch: sym_freq (..., S, 64) shifted spectra, h0 (...,
    52) the LS estimate, pol (S,) each symbol's pilot polarity; ``mcs``
    the decision constellation (None: unit-modulus proxy); ``sig_first``:
    symbol 0 is SIGNAL, decided as BPSK. Returns (eq (..., S, 48)
    complex64, csi (..., S, 48) float32, |H|^2 before each update)."""
    algo = ChannelEstimator(algo)
    if algo not in (ChannelEstimator.LMS, ChannelEstimator.STA):
        raise ValueError(f"track_eq: {algo.name} carries no estimate")
    if sym_freq.device.type != "cuda":
        raise ValueError(f"track_eq: unsupported device {sym_freq.device}")
    if sym_freq.shape[-1] != 64 or h0.shape[-1] != 52:
        raise ValueError(f"track_eq: expected (..., S, 64) and (..., 52), got "
                         f"{tuple(sym_freq.shape)} and {tuple(h0.shape)}")
    lead, s = sym_freq.shape[:-2], sym_freq.shape[-2]
    spec = sym_freq.to(torch.complex64).reshape(-1, s, 64).contiguous()
    rows = spec.shape[0]
    h = h0.to(torch.complex64).expand(lead + (52,)).reshape(rows, 52).contiguous()
    pol = pol.to(device=spec.device, dtype=torch.float32).expand(s).contiguous()
    eq = torch.empty((rows, s, 48), dtype=torch.complex64, device=spec.device)
    csi = torch.empty((rows, s, 48), dtype=torch.float32, device=spec.device)
    if rows and s:
        decision, levels, level, bpsk = decision_args(mcs)
        lvl = (ctypes.c_float * 8)(*level)
        bp = (ctypes.c_float * 2)(*bpsk)
        err = build.library().gwt_track_eq(
            spec.data_ptr(), h.data_ptr(), pol.data_ptr(), eq.data_ptr(), csi.data_ptr(),
            rows, s, int(algo), decision, int(bool(sig_first) and decision == QAM),
            levels, lvl, bp, lms_mu, sta_alpha, sta_beta,
            torch.cuda.current_stream(spec.device).cuda_stream)
        build.check(err, "track_eq")
        build.count_launch(track_eq, (sym_freq, h0, pol, algo, mcs, sig_first,
                                      lms_mu, sta_alpha, sta_beta))
    return eq.reshape(lead + (s, 48)), csi.reshape(lead + (s, 48))


track_eq.launches = 0


# Bounds (ms on the card, ``roofline``)
# ----------------------------------------------------------------------

# bytes a frame (its 52-carrier LS estimate read) and a symbol-step (its
# 52 used bins read, 48 equalized symbols and 48 weights written)
K5_BYTES_PER_ROW = 52 * 8
K5_BYTES_PER_STEP = 52 * 8 + 48 * 8 + 48 * 4
# float32 operations a symbol-step in the kernel's form, counted at the
# instruction rate: the pilot phase once (4 products of 8, 3 complex adds,
# |c|, clamp and scale: 45) and, a carrier, the phase rotation 6, |h| and
# its guard 6, Smith's division 13, a decision on two 2-level axes 16, the
# pilot overwrite, |x|^2, clamp and reciprocal 5, the STA update 30 and
# the weight 1 (77)
K5_OPS_PER_STEP = 45 + 52 * 77
# the chain floor, a design estimate in dependent cycles a symbol: the
# pilot product 12, the 4 broadcast shuffles ~30, their sum 12, |c| and
# the scale ~50, the rotation 8, Smith's division ~70, the decision ~30,
# |x|^2 and its reciprocal ~30, the update's product 16, the neighbour
# shuffles ~30, their sum and scale 20, the two blends 16
K5_CYCLES_PER_STEP = 324


def track_bound(rows: int, symbols: int) -> dict:
    """K5's bound for ``rows`` frames holding ``symbols`` symbol-steps in
    all (frames x symbols, summed): each estimate read once, each step's
    bins read and its outputs written once, each step's operations."""
    return roofline.bound(rows * K5_BYTES_PER_ROW + symbols * K5_BYTES_PER_STEP,
                          symbols * K5_OPS_PER_STEP, roofline.FP32_INSTR_PER_S)


def chain_floor_ms(symbols: int, sm_mhz: float) -> float:
    """The design's floor for one frame of ``symbols`` symbols at an SM
    clock of ``sm_mhz``: the steps one after the other, whatever the
    number of frames."""
    return symbols * K5_CYCLES_PER_STEP / (sm_mhz * 1e3)

