"""SIGNAL field (802.11a 17.3.4) encode/decode.

PyTorch port of the JAX package's phy/signal_field.py. 24 bits: RATE (4)
| reserved 0 | LENGTH (12, LSB first) | even PARITY over bits 0..16 | 6
zero tail bits; BCC rate 1/2, never scrambled or punctured, BPSK
interleaved as one 48-bit OFDM symbol.
"""

from __future__ import annotations

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits as bitops
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mapping, viterbi
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import param_table

_BPSK_MCS = 0  # interleaver/mapper run with BPSK tables (NCBPS=48)


def signal_bits(mcs: int, length: torch.Tensor) -> torch.Tensor:
    """Uncoded 24 SIGNAL bits. length: (...,) PSDU byte count."""
    dev = length.device
    batch = length.shape
    rate_b = param_table("MCS_RATE_BITS", dev, torch.uint8)[mcs].expand(batch + (4,))
    reserved = torch.zeros(batch + (1,), dtype=torch.uint8, device=dev)
    len_b = ((length[..., None].long() >> torch.arange(12, device=dev)) & 1).to(torch.uint8)
    parity = (rate_b.long().sum(-1) + len_b.long().sum(-1)) % 2
    tail = torch.zeros(batch + (6,), dtype=torch.uint8, device=dev)
    return torch.cat([rate_b, reserved, len_b, parity[..., None].to(torch.uint8), tail],
                     dim=-1)


def encode(mcs: int, length: torch.Tensor) -> torch.Tensor:
    """SIGNAL bits -> 48 BPSK symbols (one OFDM symbol's data carriers)."""
    coded = bitops.conv_encode(signal_bits(mcs, length))          # (..., 48)
    return mapping.map_bits(bitops.interleave(coded, _BPSK_MCS), _BPSK_MCS)


def signal_llrs(symbols: torch.Tensor) -> torch.Tensor:
    """Equalized SIGNAL symbols (..., 48) -> the (..., 48) deinterleaved
    mother-code LLRs of its 24-step terminated trellis."""
    return bitops.deinterleave(mapping.demap_llr(symbols, _BPSK_MCS), _BPSK_MCS)


def parse(raw: torch.Tensor) -> dict:
    """Decoded SIGNAL bits (..., 24) -> dict of fields: rate_idx (MCS
    0..7, or -1 for invalid RATE bits), length (PSDU bytes), parity_ok
    (even parity and zero tail) and raw_bits."""
    rate_bits = raw[..., 0:4].long()
    table = param_table("MCS_RATE_BITS", raw.device, torch.long)             # (8, 4)
    match = (rate_bits[..., None, :] == table).all(dim=-1)       # (..., 8)
    rate_idx = torch.where(match.any(dim=-1),
                           torch.argmax(match.to(torch.uint8), dim=-1), -1)
    length = (raw[..., 5:17].long() << torch.arange(12, device=raw.device)).sum(-1)
    parity_ok = (raw[..., 0:18].long().sum(-1) % 2) == 0
    tail_ok = (raw[..., 18:24] == 0).all(dim=-1)
    return {
        "rate_idx": rate_idx.to(torch.int32),
        "length": length.to(torch.int32),
        "parity_ok": parity_ok & tail_ok,
        "raw_bits": raw,
    }


def decode(symbols: torch.Tensor) -> dict:
    """Decode equalized SIGNAL symbols (..., 48) -> dict of fields (see
    ``parse``)."""
    return parse(viterbi.decode(signal_llrs(symbols), 24, terminated=True))
