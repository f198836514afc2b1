"""Vectorised IEEE 802.11a TX (Clause 17), written from the frozen oracle.

``transmit(psdus, mcs, seeds)`` makes the bursts of a batch of frames of
one rate and one length at once: the same scrambler, encoder, puncturing,
interleaver, mapping, pilots, IFFT scaling and CP-with-rolloff
serialisation as ``oracle_modem.transmit``, over arrays instead of loops.
The oracle takes tens of milliseconds a frame; this takes about as long
for a whole batch, so a run's set-up can make thousands of frames.
test_benchmark_yardstick.py holds it sample for sample against the
oracle. NumPy only.
"""

from __future__ import annotations

import numpy as np

from yardstick import oracle_modem as om

MCS_MBPS = (6, 9, 12, 18, 24, 36, 48, 54)      # MCS index -> Mb/s (Table 78)
PREAMBLE_LEN = 320
SYM = 80


def n_sym(mcs: int, length: int) -> int:
    """Data symbols of a frame of ``length`` PSDU bytes at ``mcs``."""
    n_dbps = om.RATE_TABLE[MCS_MBPS[mcs]][2]
    return -(-(16 + 8 * length + 6) // n_dbps)


def burst_len(mcs: int, length: int) -> int:
    """Samples of a burst: preamble, SIGNAL, data, one blended tail sample."""
    return PREAMBLE_LEN + SYM * (1 + n_sym(mcs, length)) + 1


def trellis_steps(length: int) -> int:
    """Payload trellis steps a frame needs: SERVICE, PSDU and tail bits."""
    return 16 + 8 * length + 6


def seed_bits(seed: int) -> list[int]:
    """Scrambler seed 1..127 -> its 7 register bits in x7..x1 order."""
    return [(seed >> (6 - i)) & 1 for i in range(7)]


def _scrambler(seeds: np.ndarray, n: int) -> np.ndarray:
    """(F,) seeds -> (F, n) scrambler bits; the LFSR's period is 127."""
    table = {int(s): om.scrambler_stream(seed_bits(int(s)), 127) for s in np.unique(seeds)}
    reps = -(-n // 127)
    return np.stack([np.tile(table[int(s)], reps)[:n] for s in seeds])


def _conv_encode(u: np.ndarray) -> np.ndarray:
    """(F, N) bits -> (F, 2N) mother code A1 B1 A2 B2 ..., zero start state:
    A taps the input 0, 2, 3, 5, 6 steps back (133 octal), B 0, 1, 2, 3, 6
    (171 octal)."""
    f, n = u.shape
    up = np.concatenate([np.zeros((f, 6), np.uint8), u], axis=1)

    def back(d):
        return up[:, 6 - d: 6 - d + n]

    out = np.empty((f, 2 * n), np.uint8)
    out[:, 0::2] = back(0) ^ back(2) ^ back(3) ^ back(5) ^ back(6)
    out[:, 1::2] = back(0) ^ back(1) ^ back(2) ^ back(3) ^ back(6)
    return out


_KEEP = {(1, 2): [True], (2, 3): [True, True, True, False],
         (3, 4): [True, True, True, False, False, True]}


def _puncture(coded: np.ndarray, rate) -> np.ndarray:
    keep = np.resize(np.array(_KEEP[rate]), coded.shape[1])
    return coded[:, keep]


def _interleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    """Index array p with out = bits[..., p] for one symbol (17.3.5.7)."""
    s = max(n_bpsc // 2, 1)
    k = np.arange(n_cbps)
    i = (n_cbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
    perm = np.empty(n_cbps, np.int64)
    perm[j] = k
    return perm


def _axis_table(h: int) -> np.ndarray:
    """Per-axis amplitudes indexed by the axis bits read MSB first."""
    axis = {1: om._BPSK_AXIS, 2: om._PAM2, 3: om._PAM3}[h]
    out = np.empty(1 << h)
    for bits, v in axis.items():
        out[int("".join(map(str, bits)), 2)] = v
    return out


def _map(bits: np.ndarray, n_bpsc: int) -> np.ndarray:
    """(F, n) bits -> (F, n / n_bpsc) complex points (17.3.5.8)."""
    g = bits.reshape(bits.shape[0], -1, n_bpsc).astype(np.int64)
    if n_bpsc == 1:
        return (2.0 * g[..., 0] - 1.0).astype(np.complex128)
    h = n_bpsc // 2
    w = 1 << np.arange(h - 1, -1, -1)
    tab = _axis_table(h)
    i_idx = (g[..., :h] * w).sum(-1)
    q_idx = (g[..., h:] * w).sum(-1)
    return (tab[i_idx] + 1j * tab[q_idx]) * om.KMOD[n_bpsc]


_DATA = np.array(om.DATA_CARRIERS) + 32
_PILOT = np.array(om.PILOT_CARRIERS) + 32
_PILOT_VALUES = np.array(om.PILOT_VALUES)


def spectra(points: np.ndarray, symbol_index0: int) -> np.ndarray:
    """(F, S, 48) data points -> (F, S, 64) shifted spectra with pilots of
    polarity p_(symbol_index0 + s)."""
    f, s, _ = points.shape
    spec = np.zeros((f, s, 64), np.complex128)
    spec[:, :, _DATA] = points
    pol = om.POLARITY[(symbol_index0 + np.arange(s)) % 127]
    spec[:, :, _PILOT] = pol[:, None] * _PILOT_VALUES
    return spec


def _time(spec: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1) * om.IFFT_SCALE


_PRE_SYMS = np.stack([om.time_symbol(om.STF_FREQ), om.time_symbol(om.STF_FREQ),
                      np.roll(om.time_symbol(om.LTF_FREQ), 16), om.time_symbol(om.LTF_FREQ)])


def transmit(psdus: np.ndarray, mcs: int, seeds: np.ndarray):
    """(F, L) uint8 PSDUs at ``mcs`` with (F,) scrambler seeds 1..127 ->
    (bursts (F, burst_len) complex128, data points (F, n_sym, 48))."""
    psdus = np.asarray(psdus, np.uint8)
    f, length = psdus.shape
    n_bpsc, rate, n_dbps = om.RATE_TABLE[MCS_MBPS[mcs]]
    n_cbps = 48 * n_bpsc
    ns = n_sym(mcs, length)
    n_bits = ns * n_dbps
    bits = np.zeros((f, n_bits), np.uint8)
    bits[:, 16: 16 + 8 * length] = np.unpackbits(psdus, axis=1, bitorder="little")
    scrambled = bits ^ _scrambler(np.asarray(seeds), n_bits)
    scrambled[:, 16 + 8 * length: 16 + 8 * length + 6] = 0
    punct = _puncture(_conv_encode(scrambled), rate)
    perm = _interleave_perm(n_cbps, n_bpsc)
    inter = punct.reshape(f, ns, n_cbps)[:, :, perm].reshape(f, -1)
    points = _map(inter, n_bpsc).reshape(f, ns, 48)

    sig = om.signal_field_bits(MCS_MBPS[mcs], length)
    sig_points = om.map_symbols(om.interleave(om.conv_encode(sig), 1, 48), 1)
    spec = np.concatenate([spectra(np.broadcast_to(sig_points, (f, 1, 48)), 0),
                           spectra(points, 1)], axis=1)
    syms = np.concatenate([np.broadcast_to(_PRE_SYMS, (f,) + _PRE_SYMS.shape),
                           _time(spec)], axis=1)                       # (F, K, 64)
    k = syms.shape[1]
    blocks = np.concatenate([syms[:, :, 48:], syms], axis=-1)          # CP16 + symbol
    blocks[:, :, 0] = 0.5 * syms[:, :, 48]
    blocks[:, 1:, 0] += 0.5 * syms[:, :-1, 0]
    out = np.empty((f, SYM * k + 1), np.complex128)
    out[:, :-1] = blocks.reshape(f, -1)
    out[:, -1] = 0.5 * syms[:, -1, 0]
    return out, points
