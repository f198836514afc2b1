"""Waveform-level channel impairments: AWGN + CFO + multipath + sample
clock offset.

PyTorch port of the JAX package's channel/model.py: GNU Radio's
channels.channel_model as the reference loopback harness configures it
(noise_voltage, frequency_offset = epsilon * freq / 10e6, taps) together
with the SNR pre-scaling multiply_const(10^(snr/20)).

The functions batch over leading axes and run on the input tensor's
device. The noise comes from an explicit ``torch.Generator`` (on that
device), where the JAX package takes a PRNG key; the two packages' noise
therefore differs, and everything else is deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table


def awgn(generator: torch.Generator, x: torch.Tensor,
         noise_voltage: float | torch.Tensor = 1.0) -> torch.Tensor:
    """Add complex white Gaussian noise with per-component std
    noise_voltage/sqrt(2) (total noise power = noise_voltage^2), matching
    channel_model's noise_voltage convention."""
    std = torch.as_tensor(noise_voltage, dtype=torch.float32, device=x.device) / math.sqrt(2.0)
    re = torch.randn(x.shape, generator=generator, device=x.device)
    im = torch.randn(x.shape, generator=generator, device=x.device)
    return (x + std * torch.complex(re, im)).to(torch.complex64)


def apply_cfo(x: torch.Tensor, frequency_offset: float | torch.Tensor) -> torch.Tensor:
    """Carrier frequency offset. ``frequency_offset`` is normalized to the
    sample rate (cycles/sample), the channel_model convention."""
    n = torch.arange(x.shape[-1], device=x.device)
    fo = torch.as_tensor(frequency_offset, dtype=torch.float32, device=x.device)
    rot = torch.exp(2j * math.pi * fo[..., None] * n)
    return (x * rot).to(torch.complex64)


def multipath(x: torch.Tensor, taps) -> torch.Tensor:
    """FIR multipath: y[n] = sum_k taps[k] x[n-k] (causal, same length).
    Taps given as a tuple are a constant cached on x's device."""
    if isinstance(taps, tuple):
        taps = device_table(np.asarray, taps, device=x.device, dtype=torch.complex64)
    else:
        taps = torch.as_tensor(taps, dtype=torch.complex64, device=x.device)
    k = taps.shape[-1]
    if k == 1:
        return (x * taps[..., 0]).to(torch.complex64)
    n = x.shape[-1]
    xp = torch.cat([torch.zeros(x.shape[:-1] + (k - 1,), dtype=x.dtype, device=x.device), x],
                   dim=-1)
    y = sum(taps[j] * xp[..., k - 1 - j: k - 1 - j + n] for j in range(k))
    return y.to(torch.complex64)


def sample_clock_offset(x: torch.Tensor, ppm: float, n_taps: int = 16) -> torch.Tensor:
    """Sample-clock (timing) offset: resample x at rate (1 + ppm*1e-6).

    Models channel_model's epsilon (the TX/RX ADC clock mismatch) as
    windowed-sinc fractional interpolation: y[m] = x(m * (1 + delta)), with
    float32 positions as in the JAX package. The output is slightly
    shorter than the input when delta > 0.
    """
    delta = ppm * 1e-6
    n = x.shape[-1]
    n_out = int(n / max(1.0 + delta, 1e-9)) - n_taps
    dev = x.device
    t = torch.arange(n_out, dtype=torch.float32, device=dev) * torch.tensor(
        1.0 + delta, dtype=torch.float32, device=dev)
    base = torch.floor(t).to(torch.int64)
    frac = t - base.to(torch.float32)
    k = torch.arange(-(n_taps // 2 - 1), n_taps // 2 + 1, device=dev)       # (K,)
    idx = torch.clamp(base[:, None] + k[None, :], 0, n - 1)                  # (M, K)
    arg = k[None, :].to(torch.float32) - frac[:, None]
    # windowed sinc, Hann window evaluated continuously over the tap span
    w = torch.sinc(arg) * (0.5 + 0.5 * torch.cos(math.pi * arg / (n_taps // 2 + 1)))
    w = w / w.sum(dim=-1, keepdim=True)
    return (x[..., idx] * w.to(x.dtype)).sum(dim=-1).to(torch.complex64)


def channel_model(
    generator: torch.Generator,
    x: torch.Tensor,
    noise_voltage: float | torch.Tensor = 1.0,
    frequency_offset: float | torch.Tensor = 0.0,
    taps=(1.0,),
    snr_db: float | torch.Tensor | None = None,
    clock_ppm: float = 0.0,
) -> torch.Tensor:
    """Full loopback channel: TX -> multiply_const(10^(snr/20)) ->
    channel_model(noise_voltage, frequency_offset, taps) -> RX. If
    ``snr_db`` is given, the signal is pre-scaled by 10^(snr/20) as the
    loopback slider does; otherwise the caller owns scaling."""
    if snr_db is not None:
        ten = device_table(np.float32, 10.0, device=x.device)
        x = x * ten ** (torch.as_tensor(snr_db, dtype=torch.float32, device=x.device) / 20.0)
    y = multipath(x, taps)
    y = apply_cfo(y, frequency_offset)
    if clock_ppm:
        y = sample_clock_offset(y, clock_ppm)
    return awgn(generator, y, noise_voltage)


def epsilon_to_frequency_offset(epsilon: float, carrier_hz: float = 5e9) -> float:
    """Convert the reference GUI's epsilon slider (raw fractional offset in
    [-20e-6, 20e-6]) to channel_model's normalized cycles/sample with the
    flowgraph's exact expression epsilon * freq / 10e6 (a hard-coded 10e6
    denominator, independent of the sample rate)."""
    return epsilon * carrier_hz / 10e6
