"""Channel estimation and per-symbol equalization with pilot phase tracking.

PyTorch port of the LS path of the JAX package's phy/equalizer.py: the LS
channel estimate from the two LTF symbols, a per-symbol common phase from
the 4 pilots, and equalization of the 48 data carriers. LS keeps the
channel estimate fixed, so the JAX package's scan over symbols becomes one
batched pass over all of them. The LMS, COMB and STA trackers are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def ls_estimate(ltf1: torch.Tensor, ltf2: torch.Tensor) -> torch.Tensor:
    """LS channel estimate on the 52 used carriers from the two LTF spectra
    (..., 64) -> H (..., 52) complex64."""
    used = _idx(params.USED_BINS, ltf1.device)
    ref = torch.as_tensor(params.LTF_USED, device=ltf1.device)   # +-1 on used carriers
    y = 0.5 * (ltf1[..., used] + ltf2[..., used])
    return (y * ref).to(torch.complex64)                        # ref is +-1 => y/ref


def _pilot_phase(y_used: torch.Tensor, h: torch.Tensor, polarity: torch.Tensor) -> torch.Tensor:
    """Common phase phasor e^{j phi} (...,) of each symbol from its 4 pilots.

    y_used, h: (..., 52); polarity broadcastable to (...,).
    """
    p_idx = _idx(params.PILOT_IN_USED, y_used.device)
    ref = polarity[..., None] * torch.as_tensor(params.PILOT_PATTERN, device=y_used.device)
    corr = (y_used[..., p_idx] * torch.conj(h[..., p_idx]) * ref).sum(dim=-1)
    return corr / torch.clamp(corr.abs(), min=1e-12)


def equalize(
    sym_freq: torch.Tensor,
    h0: torch.Tensor,
    symbol_index0: int = 0,
    algo: ChannelEstimator = ChannelEstimator.LS,
    mcs: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalize a run of OFDM symbols.

    sym_freq: (..., S, 64) shifted spectra (SIGNAL first when
      symbol_index0 == 0); h0: (..., 52) LS channel estimate.
    Returns (eq_data, csi): (..., S, 48) equalized data-carrier symbols and
    per-carrier reliability weights |H|^2.
    """
    algo = ChannelEstimator(algo)
    if algo != ChannelEstimator.LS:
        raise NotImplementedError(
            f"channel estimator {algo.name} is not ported yet (LS only)")
    dev = sym_freq.device
    d_idx = _idx(params.DATA_IN_USED, dev)
    y_all = sym_freq[..., _idx(params.USED_BINS, dev)]           # (..., S, 52)
    s = y_all.shape[-2]
    pol = torch.as_tensor(params.POLARITY, device=dev)[
        (symbol_index0 + torch.arange(s, device=dev)) % 127]    # (S,)
    h = h0.to(torch.complex64)[..., None, :]                     # (..., 1, 52)
    phasor = _pilot_phase(y_all, h, pol)                         # (..., S)
    y_corr = y_all * torch.conj(phasor)[..., None]
    h_safe = torch.where(h.abs() > 1e-9, h, torch.full_like(h, 1e-9))
    eq = y_corr / h_safe
    csi = (h[..., d_idx].abs() ** 2).to(torch.float32).expand(eq.shape[:-1] + (48,))
    return eq[..., d_idx], csi
