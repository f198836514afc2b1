"""IEEE 802.11a (Clause 17) PHY constants, precomputed as NumPy arrays.

Everything here is static configuration: MCS tables, carrier maps, pilot
polarity, preamble waveforms, interleaver permutations, and constellation
tables. The values replicate the behavior the reference configures into the
gr-ieee802-11 / GNU Radio C++ blocks:

  - occupied/pilot carriers + sync words: wifi_phy_hier.grc:336-405
    (digital_ofdm_carrier_allocator_cvc parameters)
  - 1/sqrt(52) IFFT scaling:              wifi_phy_hier.grc:459-479
  - cyclic prefix 16, rolloff 2:          wifi_phy_hier.grc:406-424
  - MCS set BPSK-1/2 .. 64QAM-3/4:        IRS_user.py:130-132
  - scrambler / convolutional code / puncturing / interleaving behavior:
    ieee802_11.mapper (wifi_phy_hier.grc:570-586), fixed by 802.11a-1999 §17.

A key structural fact exploited here: the reference's four frequency-domain
"sync words" + per-symbol CP16 reconstruct the *standard* 802.11a preamble
exactly (sync word 3 is the LTF rotated by (-j)^k, i.e. a 16-sample cyclic
time shift, which makes all CP junctions cyclically continuous). So the
preamble is precomputed here directly as the standard STF+LTF waveform.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Basic OFDM geometry
# ---------------------------------------------------------------------------

N_FFT = 64
N_CP = 16
N_SYM = N_FFT + N_CP                    # 80 samples per OFDM symbol
N_DATA_CARRIERS = 48
N_PILOTS = 4
PREAMBLE_LEN = 320                      # 160 STF + 160 LTF
SIGNAL_SYMBOLS = 1                      # one BPSK-1/2 SIGNAL symbol

# Data subcarrier indices (logical carrier numbers, -26..26 excluding pilots
# and DC) exactly as configured at wifi_phy_hier.grc:346-348.
DATA_CARRIERS = np.array(
    list(range(-26, -21)) + list(range(-20, -7)) + list(range(-6, 0))
    + list(range(1, 7)) + list(range(8, 21)) + list(range(22, 27)),
    dtype=np.int32,
)
assert DATA_CARRIERS.shape == (48,)

PILOT_CARRIERS = np.array([-21, -7, 7, 21], dtype=np.int32)   # wifi_phy_hier.grc:349
PILOT_PATTERN = np.array([1, 1, 1, -1], dtype=np.float32)     # base pilot values

# FFT-shifted bin positions (index into a [-32..31] shifted spectrum).
DATA_BINS = (DATA_CARRIERS + N_FFT // 2).astype(np.int32)
PILOT_BINS = (PILOT_CARRIERS + N_FFT // 2).astype(np.int32)

# All 52 used carriers in carrier order (for channel estimation).
USED_CARRIERS = np.sort(np.concatenate([DATA_CARRIERS, PILOT_CARRIERS]))
USED_BINS = (USED_CARRIERS + N_FFT // 2).astype(np.int32)

# Index of each data/pilot bin within the 52 used bins.
DATA_IN_USED = np.searchsorted(USED_BINS, DATA_BINS).astype(np.int32)
PILOT_IN_USED = np.searchsorted(USED_BINS, PILOT_BINS).astype(np.int32)

# ---------------------------------------------------------------------------
# Scrambler (x^7 + x^4 + 1) and the 127-bit pilot polarity sequence
# ---------------------------------------------------------------------------


def scrambler_sequence(seed: int, n: int) -> np.ndarray:
    """Output bits of the 802.11a frame-synchronous scrambler.

    Feedback x^7+x^4+1: out = s6 ^ s3; shift in `out`. ``seed`` is the 7-bit
    initial state with bit 6 = x^7 stage (all-ones seed gives the standard
    127-periodic sequence used for the pilot polarity).
    """
    state = [(seed >> i) & 1 for i in range(7)]  # state[6] = x^7 stage
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        fb = state[6] ^ state[3]
        out[i] = fb
        state = [fb] + state[:6]
    return out


# Pilot polarity p_0..p_126 = 1 - 2*scrambler(all-ones) per 802.11a 17.3.5.9;
# symbol 0 (SIGNAL) uses p_0. Matches the explicit pilot_symbols tuples at
# wifi_phy_hier.grc:350-371 (entry n = polarity[n] * (1,1,1,-1)).
POLARITY = (1 - 2 * scrambler_sequence(0x7F, 127).astype(np.int32)).astype(np.float32)

# ---------------------------------------------------------------------------
# Preamble: STF + LTF (frequency-domain definitions and time-domain waveform)
# ---------------------------------------------------------------------------

# STF frequency-domain symbol: sqrt(13/6)*(1+1j) pattern on carriers that are
# multiples of 4 (wifi_phy_hier.grc sync word 1/2; 802.11a 17.3.3).
_STF_SIGNS = {  # carrier -> sign of sqrt(13/6)*(1+1j)
    -24: 1, -20: -1, -16: 1, -12: -1, -8: -1, -4: 1,
    4: -1, 8: -1, 12: 1, 16: 1, 20: 1, 24: 1,
}
STF_FREQ = np.zeros(N_FFT, dtype=np.complex64)           # shifted order [-32..31]
for _c, _s in _STF_SIGNS.items():
    STF_FREQ[_c + N_FFT // 2] = _s * np.sqrt(13.0 / 6.0) * (1 + 1j)

# LTF frequency-domain symbol (wifi_phy_hier.grc sync word 4; 802.11a 17.3.3).
_LTF_CARRIER_VALS = np.array(
    # carriers -26..-1
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
    # DC
    + [0]
    # carriers 1..26
    + [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1],
    dtype=np.float32,
)
LTF_FREQ = np.zeros(N_FFT, dtype=np.complex64)
LTF_FREQ[6:59] = _LTF_CARRIER_VALS

# Known LTF values on the 52 used carriers, for LS channel estimation.
LTF_USED = LTF_FREQ[USED_BINS].real.astype(np.float32)   # all +-1

# TX IFFT convention matching fft_vcc(64, reverse, window=[1/sqrt(52)]*64):
# t[n] = (1/sqrt(52)) * sum_k X[k] e^{+j 2 pi k n / 64}  (unnormalized IFFT).
IFFT_SCALE = np.float32(N_FFT / np.sqrt(52.0))


def _time_symbol(freq_shifted: np.ndarray) -> np.ndarray:
    """64-sample time waveform of one shifted-order frequency symbol."""
    return (np.fft.ifft(np.fft.ifftshift(freq_shifted)) * IFFT_SCALE).astype(np.complex64)


LTF_TIME = _time_symbol(LTF_FREQ)                        # one 64-sample LTF period
STF_TIME16 = _time_symbol(STF_FREQ)[:16]                 # one 16-sample STF period

# Standard 320-sample preamble: 10 x STF16, then 32-sample GI2 + 2 x LTF64.
PREAMBLE = np.concatenate(
    [np.tile(STF_TIME16, 10), LTF_TIME[32:], LTF_TIME, LTF_TIME]
).astype(np.complex64)
assert PREAMBLE.shape == (PREAMBLE_LEN,)

# Offsets of the two LTF 64-sample bodies within the preamble.
LTF1_OFFSET = 192
LTF2_OFFSET = 256

# ---------------------------------------------------------------------------
# Convolutional code (K=7, g0=0133, g1=0171) and puncturing
# ---------------------------------------------------------------------------

CONV_K = 7
N_STATES = 64
G0 = 0o133
G1 = 0o171
N_TAIL_BITS = 6
N_SERVICE_BITS = 16


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.cache
def conv_tables() -> dict[str, np.ndarray]:
    """Transition tables for the K=7 encoder / Viterbi decoder.

    Convention: state = last 6 input bits, newest bit in the MSB (bit 5) —
    i.e. next_state = (state >> 1) | (bit << 5). The generator taps see the
    register [newest .. oldest] = [bit, state b5..b0 reading MSB->LSB].
    Output bit g = parity(G & register) with register bit 6 = newest input.
    """
    next_state = np.zeros((N_STATES, 2), dtype=np.int32)
    out0 = np.zeros((N_STATES, 2), dtype=np.int32)   # first coded bit (g0=0133)
    out1 = np.zeros((N_STATES, 2), dtype=np.int32)   # second coded bit (g1=0171)
    for s in range(N_STATES):
        for b in (0, 1):
            reg = (b << 6) | s                       # 7-bit register, newest at MSB
            next_state[s, b] = (s >> 1) | (b << 5)
            out0[s, b] = _parity(reg & G0)
            out1[s, b] = _parity(reg & G1)
    # Inverse view for Viterbi: for each new state, the two predecessor states
    # and the input bit / outputs on those transitions.
    prev_state = np.zeros((N_STATES, 2), dtype=np.int32)
    prev_bit = np.zeros((N_STATES, 2), dtype=np.int32)
    prev_out0 = np.zeros((N_STATES, 2), dtype=np.int32)
    prev_out1 = np.zeros((N_STATES, 2), dtype=np.int32)
    for ns in range(N_STATES):
        k = 0
        for s in range(N_STATES):
            for b in (0, 1):
                if next_state[s, b] == ns:
                    prev_state[ns, k] = s
                    prev_bit[ns, k] = b
                    prev_out0[ns, k] = out0[s, b]
                    prev_out1[ns, k] = out1[s, b]
                    k += 1
        assert k == 2
    return dict(
        next_state=next_state, out0=out0, out1=out1,
        prev_state=prev_state, prev_bit=prev_bit,
        prev_out0=prev_out0, prev_out1=prev_out1,
    )


# Puncturing patterns over the rate-1/2 mother code output pairs (A_i, B_i),
# flattened A1 B1 A2 B2 ...: True = transmit. 802.11a 17.3.5.6.
PUNCTURE_PATTERNS = {
    "1/2": np.array([1, 1], dtype=bool),
    "2/3": np.array([1, 1, 1, 0], dtype=bool),               # drop B2
    "3/4": np.array([1, 1, 1, 0, 0, 1], dtype=bool),         # drop B2, A3
}

# ---------------------------------------------------------------------------
# MCS table
# ---------------------------------------------------------------------------

# Index-aligned with config.Encoding (== reference ieee802_11.Encoding).
MCS_N_BPSC = np.array([1, 1, 2, 2, 4, 4, 6, 6], dtype=np.int32)   # bits/subcarrier
MCS_N_CBPS = MCS_N_BPSC * N_DATA_CARRIERS                          # coded bits/symbol
MCS_N_DBPS = np.array([24, 36, 48, 72, 96, 144, 192, 216], dtype=np.int32)
MCS_RATE_STR = ["1/2", "3/4", "1/2", "3/4", "1/2", "3/4", "2/3", "3/4"]
MCS_RATE_NUM = np.array([1, 3, 1, 3, 1, 3, 2, 3], dtype=np.int32)
MCS_RATE_DEN = np.array([2, 4, 2, 4, 2, 4, 3, 4], dtype=np.int32)
# SIGNAL-field RATE bits (transmitted order R1..R4), 17.3.4.1 Table 80.
MCS_RATE_BITS = np.array(
    [
        [1, 1, 0, 1],   # BPSK 1/2    (6 Mb/s)
        [1, 1, 1, 1],   # BPSK 3/4    (9 Mb/s)
        [0, 1, 0, 1],   # QPSK 1/2   (12 Mb/s)
        [0, 1, 1, 1],   # QPSK 3/4   (18 Mb/s)
        [1, 0, 0, 1],   # 16QAM 1/2  (24 Mb/s)
        [1, 0, 1, 1],   # 16QAM 3/4  (36 Mb/s)
        [0, 0, 0, 1],   # 64QAM 2/3  (48 Mb/s)
        [0, 0, 1, 1],   # 64QAM 3/4  (54 Mb/s)
    ],
    dtype=np.int32,
)
MCS_MBPS = np.array([6, 9, 12, 18, 24, 36, 48, 54], dtype=np.int32)


def n_symbols(mcs: int, psdu_bytes: int) -> int:
    """Number of data OFDM symbols for a PSDU (17.3.5.3)."""
    n_dbps = int(MCS_N_DBPS[mcs])
    return int(np.ceil((N_SERVICE_BITS + 8 * psdu_bytes + N_TAIL_BITS) / n_dbps))


# ---------------------------------------------------------------------------
# Interleaver permutations (17.3.5.7), precomputed per MCS
# ---------------------------------------------------------------------------


@functools.cache
def interleaver_perm(mcs: int) -> np.ndarray:
    """perm[k] = output position of input coded bit k within one OFDM symbol.

    Two-step permutation: k -> i (adjacent bits onto non-adjacent carriers),
    i -> j (rotation within subcarrier bit positions).
    """
    n_cbps = int(MCS_N_CBPS[mcs])
    n_bpsc = int(MCS_N_BPSC[mcs])
    s = max(n_bpsc // 2, 1)
    k = np.arange(n_cbps)
    i = (n_cbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
    perm = np.empty(n_cbps, dtype=np.int32)
    perm[k] = j
    return perm


@functools.cache
def deinterleaver_perm(mcs: int) -> np.ndarray:
    """Inverse permutation: out[j] -> original position k."""
    perm = interleaver_perm(mcs)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


# ---------------------------------------------------------------------------
# Constellations (17.3.5.8), Gray-coded, 802.11a normalization
# ---------------------------------------------------------------------------


# Per-axis Gray maps (802.11a Tables 83-86), indexed by the integer formed
# from the input bits (first-transmitted bit = MSB). 16QAM axis (2 bits):
# 00->-3, 01->-1, 11->+1, 10->+3. 64QAM axis (3 bits): 000->-7, 001->-5,
# 011->-3, 010->-1, 110->+1, 111->+3, 101->+5, 100->+7.
_AXIS_MAP = {
    1: np.array([-1.0, 1.0], dtype=np.float32),
    2: np.array([-3.0, -1.0, 3.0, 1.0], dtype=np.float32),          # 00,01,10,11
    3: np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0], dtype=np.float32),
}
# 64QAM axis check (b0b1b2 -> level): 000 -7, 001 -5, 010 -1, 011 -3,
# 100 +7, 101 +5, 110 +1, 111 +3   (Table 86).

MOD_NORM = {1: 1.0, 2: 1.0 / np.sqrt(2.0), 4: 1.0 / np.sqrt(10.0), 6: 1.0 / np.sqrt(42.0)}


@functools.cache
def constellation(n_bpsc: int) -> np.ndarray:
    """Complex constellation table indexed by the integer value of the n_bpsc
    input bits in transmission order (first bit = MSB; I bits before Q bits).

    BPSK: 1 bit -> {-1, +1}. QPSK/16QAM/64QAM: first half of bits -> I axis,
    second half -> Q axis, each Gray-coded per _AXIS_MAP, scaled by K_mod.
    """
    if n_bpsc == 1:
        return (_AXIS_MAP[1] + 0j).astype(np.complex64)
    half = n_bpsc // 2
    axis = _AXIS_MAP[half]
    pts = np.empty(2**n_bpsc, dtype=np.complex64)
    for v in range(2**n_bpsc):
        i_bits = v >> half
        q_bits = v & ((1 << half) - 1)
        pts[v] = axis[i_bits] + 1j * axis[q_bits]
    return (pts * MOD_NORM[n_bpsc]).astype(np.complex64)


# ---------------------------------------------------------------------------
# CRC-32 (IEEE 802.3, reflected, poly 0xEDB88320) — MAC FCS
# ---------------------------------------------------------------------------


@functools.cache
def crc32_table() -> np.ndarray:
    """Byte-wise CRC32 lookup table (reflected algorithm)."""
    table = np.empty(256, dtype=np.uint32)
    for b in range(256):
        c = np.uint32(b)
        for _ in range(8):
            c = np.uint32((c >> np.uint32(1)) ^ (np.uint32(0xEDB88320) * (c & np.uint32(1))))
        table[b] = c
    return table
