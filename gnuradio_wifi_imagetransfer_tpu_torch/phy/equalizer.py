"""Channel estimation and per-symbol equalization with pilot phase tracking.

PyTorch port of the JAX package's phy/equalizer.py: the LS channel
estimate from the two LTF symbols, and four equalizers selectable as
``PhyConfig.chan_est``:

  LS    static LTF estimate + per-symbol common pilot phase;
  LMS   decision-directed normalized-LMS tracking of the per-carrier
        channel: h[k] += mu * (y[k] - h[k] x̂[k]) x̂*[k] / |x̂[k]|²,
        with known pilot symbols and hard-decided data symbols;
  COMB  per-symbol complex gains at the 4 pilots, linearly interpolated
        across the 52 used carriers (flat beyond the outer pilots) and
        applied onto the LTF estimate;
  STA   spectral-temporal averaging: H_inst[k] = y[k]/x̂[k], averaged over
        ±2 neighbouring carriers (weight sta_beta), then over time (weight
        sta_alpha).

LS keeps its estimate fixed and COMB is closed-form, so each is one
batched pass over all symbols. LMS and STA carry the estimate from symbol
to symbol (the JAX package's ``lax.scan``): for CUDA tensors one launch of
the tracking kernel K5 (``ops/track_eq.py``) runs every frame's whole
recursion; for CPU tensors a Python loop over the S symbols of batched
torch ops, the kernel's plain version. Decision-directed trackers quantize
to the frame's MCS constellation when ``mcs`` is given (the SIGNAL symbol,
when it is at position 0, is decided as BPSK), else to a unit-modulus
proxy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torch.profiler import record_function

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import track_eq
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mapping, params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table, param_table

# the tracker gains' defaults are PhyConfig's, the one source of them
_GAINS = PhyConfig()


def _idx(name: str, device) -> torch.Tensor:
    return param_table(name, device, torch.long)


def ls_estimate(ltf1: torch.Tensor, ltf2: torch.Tensor) -> torch.Tensor:
    """LS channel estimate on the 52 used carriers from the two LTF spectra
    (..., 64) -> H (..., 52) complex64."""
    used = _idx("USED_BINS", ltf1.device)
    ref = param_table("LTF_USED", ltf1.device)                  # +-1 on used carriers
    y = 0.5 * (ltf1[..., used] + ltf2[..., used])
    return (y * ref).to(torch.complex64)                        # ref is +-1 => y/ref


def _pilot_phase(y_used: torch.Tensor, h: torch.Tensor, polarity: torch.Tensor) -> torch.Tensor:
    """Common phase phasor e^{j phi} (...,) of each symbol from its 4 pilots.

    y_used, h: (..., 52); polarity broadcastable to (...,).
    """
    p_idx = _idx("PILOT_IN_USED", y_used.device)
    ref = polarity[..., None] * param_table("PILOT_PATTERN", y_used.device)
    corr = (y_used[..., p_idx] * torch.conj(h[..., p_idx]) * ref).sum(dim=-1)
    return corr / torch.clamp(corr.abs(), min=1e-12)


@functools.cache
def _comb_interp_matrix() -> np.ndarray:
    """Static (52, 4) linear-interpolation weights from the 4 pilot
    positions (used-carrier indices 5, 19, 32, 46) to all 52 used
    carriers; flat-held beyond the outer pilots."""
    p = np.asarray(params.PILOT_IN_USED, dtype=np.float64)      # (4,)
    w = np.zeros((52, 4))
    for k in range(52):
        if k <= p[0]:
            w[k, 0] = 1.0
        elif k >= p[-1]:
            w[k, -1] = 1.0
        else:
            j = int(np.searchsorted(p, k, side="right")) - 1
            t = (k - p[j]) / (p[j + 1] - p[j])
            w[k, j] = 1.0 - t
            w[k, j + 1] = t
    return w.astype(np.float32)


def _decide(eq: torch.Tensor, mcs: int | None) -> torch.Tensor:
    if mcs is None:
        return eq / torch.clamp(eq.abs(), min=1e-9)          # unit-modulus proxy
    return mapping.decide(eq, mcs)


def _safe(h: torch.Tensor) -> torch.Tensor:
    """h where |h| > 1e-9, else 1e-9 (the divisor guard)."""
    return torch.where(h.abs() > 1e-9, h, torch.full_like(h, 1e-9))


def equalize(
    sym_freq: torch.Tensor,
    h0: torch.Tensor,
    symbol_index0: int | torch.Tensor = 0,
    algo: ChannelEstimator = ChannelEstimator.LS,
    mcs: int | None = None,
    lms_mu: float = _GAINS.lms_mu,
    sta_alpha: float = _GAINS.sta_alpha,
    sta_beta: float = _GAINS.sta_beta,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalize a run of OFDM symbols.

    sym_freq: (..., S, 64) shifted spectra (SIGNAL first when
      symbol_index0 == 0); h0: (..., 52) LS channel estimate.
    mcs: decision constellation of the LMS/STA trackers' data symbols
      (None: unit-modulus proxy).
    Returns (eq_data, csi): (..., S, 48) equalized data-carrier symbols and
    per-carrier reliability weights |H|^2.
    """
    algo = ChannelEstimator(algo)
    dev = sym_freq.device
    d_idx = _idx("DATA_IN_USED", dev)
    p_idx = _idx("PILOT_IN_USED", dev)
    pilot_pat = param_table("PILOT_PATTERN", dev)
    y_all = sym_freq[..., _idx("USED_BINS", dev)]                # (..., S, 52)
    s = y_all.shape[-2]
    pol = param_table("POLARITY", dev)[
        (symbol_index0 + torch.arange(s, device=dev)) % 127]    # (S,)
    h0 = h0.to(torch.complex64)

    if algo == ChannelEstimator.LS:
        # the estimate never changes: every symbol in one pass
        h = h0[..., None, :]                                     # (..., 1, 52)
        phasor = _pilot_phase(y_all, h, pol)                     # (..., S)
        eq = y_all * torch.conj(phasor)[..., None] / _safe(h)
        csi = (h[..., d_idx].abs() ** 2).to(torch.float32).expand(eq.shape[:-1] + (48,))
        return eq[..., d_idx], csi

    if algo == ChannelEstimator.COMB:
        # per-symbol pilot gains onto the LTF estimate (no carried state)
        ref = pol[:, None] * pilot_pat                           # (S, 4)
        h_p = h0[..., None, :][..., p_idx]                       # (..., 1, 4)
        g_p = y_all[..., p_idx] / _safe(h_p * ref)               # (..., S, 4)
        w = device_table(_comb_interp_matrix, device=dev, dtype=torch.complex64)
        h_t = h0[..., None, :] * torch.matmul(g_p, w.T)          # (..., S, 52)
        eq = y_all / _safe(h_t)
        return eq[..., d_idx], (h_t[..., d_idx].abs() ** 2).to(torch.float32)

    # LMS / STA: the estimate carried from symbol to symbol
    # position 0 holds the (BPSK) SIGNAL symbol iff the run starts at
    # polarity index 0 and the start index is a Python int
    sig_first = isinstance(symbol_index0, int) and symbol_index0 == 0
    # the range joins the executor's (tracing.device_profile reads
    # ``executor.*``); inside a CUDA graph the kernel's name is the span
    with record_function("executor.track"):
        if dev.type == "cuda":
            return track_eq.track_eq(sym_freq, h0, pol, algo, mcs, sig_first,
                                     lms_mu, sta_alpha, sta_beta)
        return _track_plain(y_all, h0, pol, algo, mcs, sig_first, lms_mu, sta_alpha, sta_beta)


def _track_plain(y_all, h0, pol, algo, mcs, sig_first, lms_mu, sta_alpha, sta_beta):
    """K5's plain version: the LMS or STA recursion over y_all (..., S,
    52) as a loop over the symbols."""
    dev = y_all.device
    d_idx = _idx("DATA_IN_USED", dev)
    p_idx = _idx("PILOT_IN_USED", dev)
    pilot_pat = param_table("PILOT_PATTERN", dev)
    h = h0
    data, csi = [], []
    for i in range(y_all.shape[-2]):
        y, polarity = y_all[..., i, :], pol[i]
        y_corr = y * torch.conj(_pilot_phase(y, h, polarity))[..., None]
        eq = y_corr / _safe(h)
        if sig_first and i == 0 and mcs is not None and mcs != 0:
            x_hat = _decide(eq, 0)                               # SIGNAL is BPSK
        else:
            x_hat = _decide(eq, mcs)
        x_hat[..., p_idx] = (polarity * pilot_pat).to(x_hat.dtype)
        norm = torch.clamp(x_hat.abs() ** 2, min=1e-9)
        if algo == ChannelEstimator.LMS:
            # decision-directed normalized LMS over all 52 carriers
            h_next = h + lms_mu * (y_corr - h * x_hat) * torch.conj(x_hat) / norm
        else:
            # spectral (±2 carriers, wrapping at the band edge) then
            # temporal averaging
            h_inst = y_corr * torch.conj(x_hat) / norm
            nb = (torch.roll(h_inst, 1, -1) + torch.roll(h_inst, -1, -1)
                  + torch.roll(h_inst, 2, -1) + torch.roll(h_inst, -2, -1)
                  + h_inst) / 5.0
            h_f = (1 - sta_beta) * h_inst + sta_beta * nb
            h_next = (1 - sta_alpha) * h + sta_alpha * h_f
        data.append(eq[..., d_idx])
        csi.append((h[..., d_idx].abs() ** 2).to(torch.float32))  # before the update
        h = h_next
    return torch.stack(data, dim=-2), torch.stack(csi, dim=-2)
