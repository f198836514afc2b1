"""802.11a RX chain: aligned sample burst -> decoded PSDU bytes.

PyTorch port of the JAX package's phy/rx.py: 64-point FFT demodulation,
LS equalization with pilot tracking, SIGNAL decode, soft demap,
deinterleave, depuncture, Viterbi, descramble and packing to bytes over a
batch of frames. Symbol timing comes from the caller (genie-aligned
loopback or phy/sync.py).
"""

from __future__ import annotations

import dataclasses

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits as bitops
from gnuradio_wifi_imagetransfer_tpu_torch.phy import (
    equalizer, mapping, ofdm, params, signal_field, viterbi)
from gnuradio_wifi_imagetransfer_tpu_torch.phy.tx import TxPlan


def frame_spectra(samples: torch.Tensor, n_sym: int, start: int | torch.Tensor = 0):
    """Slice bursts into LTF + SIGNAL+data spectra.

    samples: (..., N) with each frame's first preamble sample at ``start``
    (an int, or a tensor of per-frame offsets of shape (...)).
    Returns (ltf1, ltf2, syms): (..., 64), (..., 64), (..., 1+n_sym, 64).
    """
    dev = samples.device
    sym_off = (params.PREAMBLE_LEN + params.N_CP
               + torch.arange(1 + n_sym, device=dev)[:, None] * params.N_SYM
               + torch.arange(64, device=dev))                          # (S, 64)
    if isinstance(start, int):
        ltf1 = samples[..., start + params.LTF1_OFFSET: start + params.LTF1_OFFSET + 64]
        ltf2 = samples[..., start + params.LTF2_OFFSET: start + params.LTF2_OFFSET + 64]
        syms = samples[..., start + sym_off]
    else:
        s = start.long()[..., None]
        r64 = torch.arange(64, device=dev)
        ltf1 = torch.gather(samples, -1, s + params.LTF1_OFFSET + r64)
        ltf2 = torch.gather(samples, -1, s + params.LTF2_OFFSET + r64)
        flat = (s + sym_off.reshape(-1)).reshape(start.shape + (-1,))
        syms = torch.gather(samples, -1, flat).reshape(start.shape + sym_off.shape)
    return ofdm.fft_symbols(ltf1), ofdm.fft_symbols(ltf2), ofdm.fft_symbols(syms)


@dataclasses.dataclass(frozen=True)
class RxResult:
    psdu: torch.Tensor          # (..., L) uint8 decoded PSDU bytes
    sig: dict                   # SIGNAL field decode (rate_idx/length/parity_ok)
    eq_symbols: torch.Tensor    # (..., n_sym, 48) equalized data symbols
    csi: torch.Tensor           # (..., n_sym, 48) |H|^2 weights


def decode_aligned(samples: torch.Tensor, plan: TxPlan, start: int | torch.Tensor = 0,
                   algo: ChannelEstimator = ChannelEstimator.LS) -> RxResult:
    """Decode frames whose preambles start at ``start`` in ``samples``.

    The MCS/length come from ``plan`` (static shapes); the SIGNAL field is
    decoded and returned for validation but does not steer shapes.
    """
    ltf1, ltf2, spectra = frame_spectra(samples, plan.n_sym, start)
    return decode_spectra(ltf1, ltf2, spectra, plan, algo=algo)


def decode_spectra(ltf1: torch.Tensor, ltf2: torch.Tensor, spectra: torch.Tensor,
                   plan: TxPlan, algo: ChannelEstimator = ChannelEstimator.LS) -> RxResult:
    """Decode from demodulated spectra: LTF spectra (..., 64) and
    SIGNAL+data spectra (..., 1+n_sym, 64)."""
    h0 = equalizer.ls_estimate(ltf1, ltf2)
    eq, csi = equalizer.equalize(spectra, h0, symbol_index0=0, algo=algo, mcs=plan.mcs)
    data_eq = eq[..., 1:, :]
    data_csi = csi[..., 1:, :]
    llr = mapping.demap_llr(
        data_eq.reshape(data_eq.shape[:-2] + (-1,)), plan.mcs,
        csi=data_csi.reshape(data_csi.shape[:-2] + (-1,)))
    deint = bitops.deinterleave(llr, plan.mcs)
    mother = bitops.depuncture(deint, plan.rate, 2 * plan.n_data_bits)
    # The trellis terminates (state 0) right after the 6 zero tail bits;
    # scrambled PAD bits continue past it, so decode only through the tail.
    # SIGNAL's 24-step trellis and the payload's are decoded together.
    n_info = params.N_SERVICE_BITS + 8 * plan.psdu_len + params.N_TAIL_BITS
    sig_raw, decoded = viterbi.decode_many(
        [signal_field.signal_llrs(eq[..., 0, :]), mother[..., : 2 * n_info]],
        [24, n_info], [True, True])
    sig = signal_field.parse(sig_raw)
    descrambled = bitops.descramble(decoded)
    psdu_bits = descrambled[..., params.N_SERVICE_BITS: params.N_SERVICE_BITS + 8 * plan.psdu_len]
    return RxResult(psdu=bitops.bits_to_bytes(psdu_bits), sig=sig,
                    eq_symbols=data_eq, csi=data_csi)
