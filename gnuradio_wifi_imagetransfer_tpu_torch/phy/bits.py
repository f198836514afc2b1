"""Bit-level 802.11a operations: scrambler, convolutional encoder,
puncturing, interleaving and byte/bit packing, batch-first on tensors.

PyTorch port of the JAX package's phy/bits.py (802.11a-1999 §17.3.5):
the scrambler is an XOR against a phase-rolled 127-bit cycle, the encoder
a XOR of shifted views, and puncturing/interleaving are gathers with
precomputed numpy index tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table

# ---------------------------------------------------------------------------
# Scrambler (17.3.5.4)
# ---------------------------------------------------------------------------


@functools.cache
def _scrambler_cycle() -> tuple[np.ndarray, np.ndarray]:
    """(seq, phase_of_state): seq = 127-bit output cycle starting from the
    all-ones state; phase_of_state[s] = index i such that starting the LFSR
    in state s produces seq[i:] (cyclically)."""
    state = 0x7F
    seq = np.empty(127, dtype=np.uint8)
    phase = np.zeros(128, dtype=np.int64)
    for i in range(127):
        phase[state] = i
        fb = ((state >> 6) ^ (state >> 3)) & 1
        seq[i] = fb
        state = ((state << 1) | fb) & 0x7F
    return seq, phase


@functools.cache
def _windows() -> np.ndarray:
    """All 127 length-7 windows of the scrambler cycle, (127, 7)."""
    seq, _ = _scrambler_cycle()
    return np.stack([np.roll(seq, -i)[:7] for i in range(127)]).astype(np.int64)


def _cycle_part(i: int) -> np.ndarray:
    """``_scrambler_cycle()[i]`` (0: the cycle, 1: the phase of each state)."""
    return _scrambler_cycle()[i]


def scrambler_bits(n: int, seed, device=None) -> torch.Tensor:
    """First ``n`` scrambler output bits for a 7-bit ``seed``: an int gives
    (n,); a tensor of seeds gives seed.shape + (n,)."""
    seed = torch.as_tensor(seed, dtype=torch.long, device=device)
    start = device_table(_cycle_part, 1, device=seed.device)[seed]
    idx = (torch.arange(n, device=seed.device) + start[..., None]) % 127
    return device_table(_cycle_part, 0, device=seed.device)[idx]


def scramble(bits: torch.Tensor, seed) -> torch.Tensor:
    """XOR ``bits`` (..., n) with the scrambler sequence for ``seed``
    (a scalar or one seed per frame of the batch)."""
    return bits ^ scrambler_bits(bits.shape[-1], seed, bits.device).to(bits.dtype)


def descramble(bits: torch.Tensor) -> torch.Tensor:
    """Self-synchronizing descramble: the 16-bit SERVICE field is sent as
    zeros, so the first 7 received bits are the scrambler output and fix
    its phase. bits: (..., n) -> same shape."""
    n = bits.shape[-1]
    w = device_table(_windows, device=bits.device)                     # (127, 7)
    first7 = bits[..., :7].long()
    match = (first7[..., None, :] == w).all(dim=-1)                    # (..., 127)
    phase = torch.argmax(match.to(torch.uint8), dim=-1)                # first match
    idx = (torch.arange(n, device=bits.device) + phase[..., None]) % 127
    return bits ^ device_table(_cycle_part, 0, device=bits.device)[idx].to(bits.dtype)


# ---------------------------------------------------------------------------
# Convolutional encoder (17.3.5.5) — K=7, g0=0133, g1=0171
# ---------------------------------------------------------------------------


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 mother-code output, interleaved pairs A1 B1 A2 B2 ...

    bits: (..., n) in {0,1}; returns (..., 2n). Initial register state 0;
    the caller appends the 6 zero tail bits that terminate the trellis.
    """
    n = bits.shape[-1]
    x = torch.cat([bits.new_zeros(bits.shape[:-1] + (6,)), bits], dim=-1)

    def d(k):                       # input delayed by k: x[..., i + 6 - k]
        return x[..., 6 - k: 6 - k + n]

    a = d(0) ^ d(2) ^ d(3) ^ d(5) ^ d(6)        # g0 = 133o
    b = d(0) ^ d(1) ^ d(2) ^ d(3) ^ d(6)        # g1 = 171o
    return torch.stack([a, b], dim=-1).reshape(bits.shape[:-1] + (2 * n,))


# ---------------------------------------------------------------------------
# Puncturing (17.3.5.6)
# ---------------------------------------------------------------------------


@functools.cache
def puncture_indices(rate: str, n_mother: int) -> np.ndarray:
    """Indices of mother-code bits that survive puncturing (static)."""
    pattern = params.PUNCTURE_PATTERNS[rate]
    reps = int(np.ceil(n_mother / pattern.size))
    mask = np.tile(pattern, reps)[:n_mother]
    return np.nonzero(mask)[0].astype(np.int64)


def puncture(coded: torch.Tensor, rate: str) -> torch.Tensor:
    """Gather surviving bits: (..., 2n) -> (..., n_kept)."""
    idx = device_table(puncture_indices, rate, coded.shape[-1], device=coded.device)
    return coded.index_select(-1, idx)


def depuncture(llrs: torch.Tensor, rate: str, n_mother: int) -> torch.Tensor:
    """Scatter received LLRs back to mother-code positions; punctured
    positions get LLR 0 (erasure). (..., n_kept) -> (..., n_mother)."""
    idx = device_table(puncture_indices, rate, n_mother, device=llrs.device)
    out = llrs.new_zeros(llrs.shape[:-1] + (n_mother,))
    out[..., idx] = llrs
    return out


# ---------------------------------------------------------------------------
# Interleaving (17.3.5.7)
# ---------------------------------------------------------------------------


@functools.cache
def _tiled_perm(mcs: int, n_sym: int, inverse: bool) -> np.ndarray:
    """Gather index over n_sym symbols: interleaving is the gather
    out[j] = in[inv[j]], deinterleaving out[k] = in[perm[k]]."""
    n_cbps = int(params.MCS_N_CBPS[mcs])
    base = params.interleaver_perm(mcs) if inverse else params.deinterleaver_perm(mcs)
    offs = np.arange(n_sym, dtype=np.int64)[:, None] * n_cbps
    return (base[None, :] + offs).reshape(-1).astype(np.int64)


def _permute(vals: torch.Tensor, mcs: int, inverse: bool) -> torch.Tensor:
    n_sym = vals.shape[-1] // int(params.MCS_N_CBPS[mcs])
    idx = device_table(_tiled_perm, mcs, n_sym, inverse, device=vals.device)
    return vals.index_select(-1, idx)


def interleave(bits: torch.Tensor, mcs: int) -> torch.Tensor:
    """Per-symbol two-permutation interleaver. (..., n_sym*n_cbps)."""
    return _permute(bits, mcs, inverse=False)


def deinterleave(vals: torch.Tensor, mcs: int) -> torch.Tensor:
    """Inverse interleaver; works on bits or LLRs. (..., n_sym*n_cbps)."""
    return _permute(vals, mcs, inverse=True)


# ---------------------------------------------------------------------------
# Byte <-> bit packing (LSB-first per 802.11 octet transmission order)
# ---------------------------------------------------------------------------


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., n_bytes) uint8 -> (..., 8*n_bytes) bits, LSB of each byte first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(data.shape[:-1] + (data.shape[-1] * 8,)).to(torch.uint8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*n) bits -> (..., n) uint8, LSB-first."""
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def psdu_bytes(descrambled: torch.Tensor, psdu_len: int,
               lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The PSDU bytes of descrambled DATA bits (..., n) (SERVICE first):
    (..., psdu_len) uint8. With ``lengths`` (...,), each frame's own
    PSDU length (at most psdu_len), the bytes past a frame's own are 0."""
    start = params.N_SERVICE_BITS
    out = bits_to_bytes(descrambled[..., start: start + 8 * psdu_len])
    if lengths is None:
        return out
    keep = torch.arange(psdu_len, device=out.device) < lengths[..., None]
    return torch.where(keep, out, 0).to(torch.uint8)
