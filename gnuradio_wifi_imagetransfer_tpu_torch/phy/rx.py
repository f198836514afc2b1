"""802.11a RX chain: aligned sample burst -> decoded PSDU bytes.

PyTorch port of the JAX package's phy/rx.py: 64-point FFT demodulation,
equalization with pilot tracking, SIGNAL decode, soft demap,
deinterleave, depuncture, Viterbi, descramble and packing to bytes over a
batch of frames. Symbol timing comes from the caller (genie-aligned
loopback or phy/sync.py).

``PhyConfig.chan_est`` selects the equalizer and ``lms_mu`` / ``sta_alpha``
/ ``sta_beta`` tune the LMS and STA trackers; the defaults are
``PhyConfig()``'s. The port compiles nothing, so the JAX package's
``jitted_decode_aligned`` (a cache of compiled programs per (MCS, length,
algo)) has no counterpart: callers pass a ``TxPlan`` to ``decode_aligned``.
"""

from __future__ import annotations

import dataclasses

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits as bitops
from gnuradio_wifi_imagetransfer_tpu_torch.phy import (
    equalizer, mapping, ofdm, params, signal_field, viterbi)
from gnuradio_wifi_imagetransfer_tpu_torch.phy.tx import TxPlan

_GAINS = PhyConfig()


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


def decode_signal(windows: torch.Tensor, frame_start: torch.Tensor,
                  algo: ChannelEstimator = ChannelEstimator.LS, n_sym: int = 0) -> dict:
    """SIGNAL-only decode of (B, wlen) windows whose preambles start at
    ``frame_start`` (B,), the first stage of SIGNAL steering: the LTF
    estimate, the SIGNAL symbol (and n_sym data symbols after it)
    equalized with ``mcs=None``, so LMS/STA decide with the unit-modulus
    proxy, then one Viterbi launch of B 24-step trellises. Returns the
    ``signal_field.parse`` dict."""
    ltf1, ltf2, spectra = frame_spectra(windows, n_sym, frame_start)
    h0 = equalizer.ls_estimate(ltf1, ltf2)
    eq, _ = equalizer.equalize(spectra, h0, symbol_index0=0, algo=algo)
    return signal_field.decode(eq[..., 0, :])


def steerable(sig_ok, rate_idx, length, max_psdu: int):
    """Mask of SIGNAL decodes that can steer a payload decode (numpy
    arrays): parity and tail ok, a known rate, 1 <= length <= max_psdu."""
    return sig_ok & (rate_idx >= 0) & (length >= 1) & (length <= max_psdu)


def signal_buckets(rate_idx, length) -> dict[tuple[int, int], list[int]]:
    """Positions grouped by decoded (rate_idx, length), the buckets and the
    positions in each in order of first appearance: one payload decode a
    bucket."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, key in enumerate(zip(rate_idx, length)):
        buckets.setdefault((int(key[0]), int(key[1])), []).append(i)
    return buckets


@dataclasses.dataclass(frozen=True)
class RxResult:
    psdu: torch.Tensor          # (..., L) uint8 decoded PSDU bytes
    sig: dict                   # SIGNAL field decode (rate_idx/length/parity_ok)
    eq_symbols: torch.Tensor    # (..., n_sym, 48) equalized data symbols
    csi: torch.Tensor           # (..., n_sym, 48) |H|^2 weights


def decode_aligned(samples: torch.Tensor, plan: TxPlan, start: int | torch.Tensor = 0,
                   algo: ChannelEstimator = ChannelEstimator.LS,
                   lms_mu: float = _GAINS.lms_mu, sta_alpha: float = _GAINS.sta_alpha,
                   sta_beta: float = _GAINS.sta_beta,
                   lengths: torch.Tensor | None = None) -> RxResult:
    """Decode frames whose preambles start at ``start`` in ``samples``.

    The MCS/length come from ``plan`` (static shapes); the SIGNAL field is
    decoded and returned for validation but does not steer shapes (the
    adaptive executor buckets frames by their decoded SIGNAL before it
    calls this). With ``lengths`` (...,), each frame's own PSDU length
    (at most ``plan.psdu_len``, so at most ``plan.n_sym`` symbols), a batch
    holds frames of different lengths: each decodes as it would alone
    with ``TxPlan(plan.mcs, length)``, its PSDU in the first ``length``
    bytes (the rest 0) and its own symbols first in ``eq_symbols``.
    """
    ltf1, ltf2, spectra = frame_spectra(samples, plan.n_sym, start)
    return decode_spectra(ltf1, ltf2, spectra, plan, algo=algo, lms_mu=lms_mu,
                          sta_alpha=sta_alpha, sta_beta=sta_beta, lengths=lengths)


def decode_spectra(ltf1: torch.Tensor, ltf2: torch.Tensor, spectra: torch.Tensor,
                   plan: TxPlan, algo: ChannelEstimator = ChannelEstimator.LS,
                   lms_mu: float = _GAINS.lms_mu, sta_alpha: float = _GAINS.sta_alpha,
                   sta_beta: float = _GAINS.sta_beta,
                   lengths: torch.Tensor | None = None) -> RxResult:
    """Decode from demodulated spectra: LTF spectra (..., 64) and
    SIGNAL+data spectra (..., 1+n_sym, 64); ``lengths`` as in
    ``decode_aligned``. Every step up to a frame's own tail is causal (the
    equalizers and trackers symbol by symbol, demapping, deinterleaving
    and depuncturing position by position, the Viterbi recursion step by
    step), so the symbols after a shorter frame's own change nothing of
    it."""
    h0 = equalizer.ls_estimate(ltf1, ltf2)
    eq, csi = equalizer.equalize(spectra, h0, symbol_index0=0, algo=algo, mcs=plan.mcs,
                                 lms_mu=lms_mu, sta_alpha=sta_alpha, sta_beta=sta_beta)
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
    # With per-frame lengths each frame's trellis ends at its own tail.
    n_info = params.N_SERVICE_BITS + 8 * plan.psdu_len + params.N_TAIL_BITS
    own = (None if lengths is None
           else params.N_SERVICE_BITS + 8 * lengths + params.N_TAIL_BITS)
    sig_raw, decoded = viterbi.decode_many(
        [signal_field.signal_llrs(eq[..., 0, :]), mother[..., : 2 * n_info]],
        [24, n_info], [True, True], None if own is None else [None, own])
    sig = signal_field.parse(sig_raw)
    descrambled = bitops.descramble(decoded)
    return RxResult(psdu=bitops.psdu_bytes(descrambled, plan.psdu_len, lengths), sig=sig,
                    eq_symbols=data_eq, csi=data_csi)
