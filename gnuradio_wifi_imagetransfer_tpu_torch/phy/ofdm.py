"""OFDM symbol assembly and demodulation: carrier allocation, pilots,
IFFT/FFT and the cyclic prefix with rolloff-2 junction blending.

PyTorch port of the JAX package's phy/ofdm.py. The 64-point FFT stays
``torch.fft``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table, param_table


def allocate_carriers(data_syms: torch.Tensor, symbol_index0: int = 0) -> torch.Tensor:
    """Scatter 48 data symbols per OFDM symbol into the shifted 64-bin
    spectrum with polarity-scaled pilots.

    data_syms: (..., n_sym, 48) complex; symbol_index0: polarity index of
    the first symbol (SIGNAL uses 0, data symbols start at 1).
    Returns (..., n_sym, 64) shifted-order spectra.
    """
    dev = data_syms.device
    n_sym = data_syms.shape[-2]
    out = torch.zeros(data_syms.shape[:-1] + (params.N_FFT,), dtype=torch.complex64,
                      device=dev)
    out[..., param_table("DATA_BINS", dev, torch.long)] = data_syms.to(torch.complex64)
    pol_idx = (symbol_index0 + torch.arange(n_sym, device=dev)) % 127
    polarity = param_table("POLARITY", dev)[pol_idx]                        # (n_sym,)
    pilots = polarity[:, None] * param_table("PILOT_PATTERN", dev)
    out[..., param_table("PILOT_BINS", dev, torch.long)] = (
        pilots.to(torch.complex64))
    return out


def ifft_symbols(freq_syms: torch.Tensor) -> torch.Tensor:
    """Shifted-order spectra -> 64-sample time symbols with the reference's
    unnormalized-IFFT * 1/sqrt(52) scaling."""
    t = torch.fft.ifft(torch.fft.ifftshift(freq_syms, dim=-1), dim=-1)
    return (t * float(params.IFFT_SCALE)).to(torch.complex64)


def fft_symbols(time_syms: torch.Tensor) -> torch.Tensor:
    """Inverse of ifft_symbols: 64-sample time symbols -> shifted spectra."""
    f = torch.fft.fftshift(torch.fft.fft(time_syms, dim=-1), dim=-1)
    return (f / float(params.IFFT_SCALE)).to(torch.complex64)


def add_cyclic_prefix(time_syms: torch.Tensor) -> torch.Tensor:
    """CP16 + rolloff-2 junction blending over a symbol burst.

    time_syms: (..., n, 64) -> (..., n*80 + 1) serialized burst. Junction
    sample k*80 is 0.5*(this symbol's s[48] + previous symbol's s[0]); the
    burst gains one trailing sample 0.5*s_last[0]; the first sample is
    halved (up-flank against silence).
    """
    n = time_syms.shape[-2]
    blocks = torch.cat([time_syms[..., 48:], time_syms], dim=-1)   # (..., n, 80)
    flat = blocks.reshape(time_syms.shape[:-2] + (n * params.N_SYM,)).clone()
    first = time_syms[..., :, 48]
    prev_cont = time_syms[..., :, 0]
    blended = 0.5 * first
    blended[..., 1:] = blended[..., 1:] + 0.5 * prev_cont[..., :-1]
    flat[..., ::params.N_SYM] = blended
    tail = 0.5 * prev_cont[..., -1:]
    return torch.cat([flat, tail.to(flat.dtype)], dim=-1)


@functools.cache
def sync_time_symbols() -> np.ndarray:
    """The 4 preamble time symbols: STF, STF, LTF<<16, LTF — shape (4, 64)."""
    stf = np.tile(params.STF_TIME16, 4)
    ltf = params.LTF_TIME
    ltf_shift = np.roll(ltf, 16)
    return np.stack([stf, stf, ltf_shift, ltf]).astype(np.complex64)


def assemble_burst(sig_freq: torch.Tensor, data_freq: torch.Tensor) -> torch.Tensor:
    """Full frame waveform: preamble + SIGNAL + data through one CP pass.

    sig_freq: (..., 1, 64); data_freq: (..., n_sym, 64).
    Returns (..., (4+1+n_sym)*80 + 1) complex64 samples.
    """
    sync = device_table(sync_time_symbols, device=sig_freq.device).expand(
        sig_freq.shape[:-2] + (4, params.N_FFT))
    body = ifft_symbols(torch.cat([sig_freq, data_freq], dim=-2))
    return add_cyclic_prefix(torch.cat([sync, body], dim=-2))
