# Frozen copy of tests/oracle_modem.py at commit 10b5b06, the repo's
# pure-NumPy IEEE 802.11a TX oracle. It is the benchmark's reference TX:
# the traffic generator (vtx.py) is held against it, and no change to the
# program under test can move it. The copy below is verbatim.

"""Independent pure-NumPy IEEE 802.11a TX oracle.

This module is the *golden reference* for the TPU PHY: a deliberately naive,
sequential, loop-based 802.11a (Clause 17) transmitter written directly from
the standard's prose — scrambler as an explicit LFSR, convolutional encoder
as an explicit shift register, interleaver from the two-permutation formulas,
constellations typed from Tables 81/82/84/86. It imports NOTHING from
`gnuradio_wifi_imagetransfer_tpu`, so a symmetric convention error in the
package (scrambler phase, interleaver direction, Gray labeling, pilot
polarity) cannot hide here.

External anchors (not authored in this repo):
  * the 127-bit scrambler sequence published in 802.11a-1999 17.3.5.4
    (asserted in tests/test_annex_g.py);
  * CRC-32 via zlib (the FCS is IEEE 802.3 CRC32, which zlib implements);
  * the IEEE 802.11a-1999 Annex G example frame (16-QAM 3/4 rate 36 Mb/s,
    100-byte PSDU "Joy, bright spark of divinity...").

Sample scaling follows the behavior the reference configures into GNU Radio
(unnormalized 64-IFFT x 1/sqrt(52), wifi_phy_hier.grc:459-479; cyclic prefix
16 with rolloff-2 junction blending, grc:406-424) so oracle and package
waveforms are comparable sample-for-sample.
"""

from __future__ import annotations

import zlib

import numpy as np

# --- rate-dependent parameters, 802.11a Table 78 -------------------------
# Mb/s -> (bits per subcarrier, (num, den) coding rate, data bits per symbol)
RATE_TABLE = {
    6: (1, (1, 2), 24),
    9: (1, (3, 4), 36),
    12: (2, (1, 2), 48),
    18: (2, (3, 4), 72),
    24: (4, (1, 2), 96),
    36: (4, (3, 4), 144),
    48: (6, (2, 3), 192),
    54: (6, (3, 4), 216),
}

# SIGNAL RATE bits R1-R4, 802.11a Table 80 (transmission order).
SIGNAL_RATE_BITS = {
    6: (1, 1, 0, 1),
    9: (1, 1, 1, 1),
    12: (0, 1, 0, 1),
    18: (0, 1, 1, 1),
    24: (1, 0, 0, 1),
    36: (1, 0, 1, 1),
    48: (0, 0, 0, 1),
    54: (0, 0, 1, 1),
}


# --- scrambler (17.3.5.4) -------------------------------------------------

def scrambler_stream(seed_bits, n):
    """n output bits of the x^7+x^4+1 LFSR.

    seed_bits: 7 ints, the initial register contents given in x7..x1 order
    (the order the standard writes initial states, e.g. Annex G's 1011101).
    Output bit = x7 XOR x4; registers shift toward x7, output feeds x1.
    """
    x = list(seed_bits)  # x[0] = x7 ... x[6] = x1
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        fb = x[0] ^ x[3]  # x7 xor x4
        out[i] = fb
        x = x[1:] + [fb]
    return out


def scramble(bits, seed_bits):
    return bits ^ scrambler_stream(seed_bits, len(bits))


# --- convolutional encoder (17.3.5.5) -------------------------------------

def conv_encode(bits):
    """K=7 rate-1/2 encoder, g0=133o g1=171o, zero initial state.

    Output order A1 B1 A2 B2 ... (A = g0 output)."""
    g0, g1 = 0o133, 0o171
    reg = 0  # 6 delay elements; bit i of reg = input from i+1 steps ago
    out = np.empty(2 * len(bits), dtype=np.uint8)
    for i, b in enumerate(bits):
        window = (int(b) << 6) | reg  # newest bit highest, matches octal gens
        out[2 * i] = bin(window & g0).count("1") & 1
        out[2 * i + 1] = bin(window & g1).count("1") & 1
        reg = (window >> 1) & 0x3F
    return out


# --- puncturing (17.3.5.6) -------------------------------------------------

def puncture(coded, rate):
    """Drop stolen bits per Figure 114: rate 3/4 keeps A1B1A2,B3 of every 6;
    rate 2/3 keeps A1B1A2 of every 4."""
    if rate == (1, 2):
        return coded.copy()
    if rate == (2, 3):
        keep = [True, True, True, False]
    elif rate == (3, 4):
        keep = [True, True, True, False, False, True]
    else:
        raise ValueError(rate)
    mask = np.array([keep[i % len(keep)] for i in range(len(coded))])
    return coded[mask]


# --- interleaver (17.3.5.7) ------------------------------------------------

def interleave_symbol(bits, n_bpsc):
    """One OFDM symbol's N_CBPS bits through the two-permutation interleaver."""
    n_cbps = len(bits)
    s = max(n_bpsc // 2, 1)
    out = np.empty(n_cbps, dtype=bits.dtype)
    for k in range(n_cbps):
        i = (n_cbps // 16) * (k % 16) + k // 16
        j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
        out[j] = bits[k]
    return out


def interleave(bits, n_bpsc, n_cbps):
    out = np.empty_like(bits)
    for sym in range(len(bits) // n_cbps):
        out[sym * n_cbps : (sym + 1) * n_cbps] = interleave_symbol(
            bits[sym * n_cbps : (sym + 1) * n_cbps], n_bpsc
        )
    return out


# --- constellation mapping (17.3.5.8, Tables 81/82/84/86) -------------------

_BPSK = {(0,): -1.0, (1,): 1.0}
_PAM2 = {(0, 0): -3.0, (0, 1): -1.0, (1, 1): 1.0, (1, 0): 3.0}       # Table 84
_PAM3 = {                                                              # Table 86
    (0, 0, 0): -7.0, (0, 0, 1): -5.0, (0, 1, 1): -3.0, (0, 1, 0): -1.0,
    (1, 1, 0): 1.0, (1, 1, 1): 3.0, (1, 0, 1): 5.0, (1, 0, 0): 7.0,
}
KMOD = {1: 1.0, 2: 1.0 / np.sqrt(2.0), 4: 1.0 / np.sqrt(10.0), 6: 1.0 / np.sqrt(42.0)}


def map_symbols(bits, n_bpsc):
    """Groups of n_bpsc bits -> complex points: first half of the group sets
    I, second half sets Q (17.3.5.8); BPSK puts all energy on I."""
    k = KMOD[n_bpsc]
    out = []
    for g in bits.reshape(-1, n_bpsc):
        g = tuple(int(b) for b in g)
        if n_bpsc == 1:
            out.append(_BPSK[g] + 0j)
        else:
            h = n_bpsc // 2
            axis = {1: _BPSK_AXIS, 2: _PAM2, 3: _PAM3}[h]
            out.append(axis[g[:h]] + 1j * axis[g[h:]])
    return np.asarray(out, dtype=np.complex128) * k


_BPSK_AXIS = {(0,): -1.0, (1,): 1.0}  # QPSK per-axis map (Table 82)


# --- OFDM assembly (17.3.5.9 / 17.3.5.10) -----------------------------------

DATA_CARRIERS = [c for c in range(-26, 27) if c not in (-21, -7, 0, 7, 21)]
PILOT_CARRIERS = [-21, -7, 7, 21]
PILOT_VALUES = [1.0, 1.0, 1.0, -1.0]
# pilot polarity p_n = 1 - 2*scrambler(all ones) (17.3.5.9)
POLARITY = 1 - 2 * scrambler_stream([1] * 7, 127).astype(np.int64)

# GNU Radio fft_vcc(64, reverse, [1/sqrt(52)]*64) == unnormalized IFFT/sqrt(52)
IFFT_SCALE = 64.0 / np.sqrt(52.0)


def ofdm_symbol_freq(data48, symbol_index):
    """48 data points + polarity pilots -> shifted-order 64-bin spectrum."""
    spec = np.zeros(64, dtype=np.complex128)
    for c, d in zip(DATA_CARRIERS, data48):
        spec[c + 32] = d
    pol = POLARITY[symbol_index % 127]
    for c, p in zip(PILOT_CARRIERS, PILOT_VALUES):
        spec[c + 32] = pol * p
    return spec


def time_symbol(spec_shifted):
    return np.fft.ifft(np.fft.ifftshift(spec_shifted)) * IFFT_SCALE


# --- preamble (17.3.3) ------------------------------------------------------

STF_FREQ = np.zeros(64, dtype=np.complex128)
for _c, _s in [(-24, 1), (-20, -1), (-16, 1), (-12, -1), (-8, -1), (-4, 1),
               (4, -1), (8, -1), (12, 1), (16, 1), (20, 1), (24, 1)]:
    STF_FREQ[_c + 32] = np.sqrt(13.0 / 6.0) * _s * (1 + 1j)

LTF_SEQ = np.array(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1,
     -1, 1, 1, 1, 1, 0, 1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1,
     1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1], dtype=np.float64)
LTF_FREQ = np.zeros(64, dtype=np.complex128)
LTF_FREQ[32 - 26 : 32 + 27] = LTF_SEQ


def preamble():
    """320 samples: 10 short symbols then GI2 + 2 long symbols."""
    stf16 = time_symbol(STF_FREQ)[:16]
    ltf64 = time_symbol(LTF_FREQ)
    return np.concatenate([np.tile(stf16, 10), ltf64[32:], ltf64, ltf64])


# --- MAC / PSDU --------------------------------------------------------------

def fcs(mpdu_body: bytes) -> bytes:
    """IEEE CRC-32 of header+payload, transmitted LSByte first (zlib is an
    independent implementation of the same reflected CRC-32)."""
    return (zlib.crc32(mpdu_body) & 0xFFFFFFFF).to_bytes(4, "little")


# The Annex G example frame (IEEE 802.11a-1999 Annex G, Table G.1):
# rate 36 Mb/s, 100-octet PSDU, scrambler initial state 1011101.
ANNEX_G_MESSAGE = (
    b"Joy, bright spark of divinity,\nDaughter of Elysium,\n"
    b"Fire-insired we trea"
)
ANNEX_G_HEADER = bytes(
    [0x04, 0x02, 0x00, 0x2E, 0x00, 0x60, 0x08, 0xCD, 0x37, 0xA6, 0x00, 0x20,
     0xD6, 0x01, 0x3C, 0xF1, 0x00, 0x60, 0x08, 0xAD, 0x3B, 0xAF, 0x00, 0x00]
)
ANNEX_G_SEED = (1, 0, 1, 1, 1, 0, 1)  # x7..x1
ANNEX_G_RATE_MBPS = 36


def annex_g_psdu() -> bytes:
    body = ANNEX_G_HEADER + ANNEX_G_MESSAGE
    psdu = body + fcs(body)
    assert len(psdu) == 100
    return psdu


# --- full TX ------------------------------------------------------------------

def bytes_to_bits(data: bytes) -> np.ndarray:
    """LSB-first per octet (802.11 transmission order)."""
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    return ((a[:, None] >> np.arange(8)) & 1).reshape(-1).astype(np.uint8)


def signal_field_bits(rate_mbps, length):
    """24 uncoded SIGNAL bits: RATE | reserved | LENGTH lsb-first | parity | tail."""
    bits = list(SIGNAL_RATE_BITS[rate_mbps]) + [0]
    bits += [(length >> i) & 1 for i in range(12)]
    bits.append(sum(bits) % 2)
    bits += [0] * 6
    return np.array(bits, dtype=np.uint8)


class TxStages:
    """All intermediate products of one oracle TX, for stage-level asserts."""

    def __init__(self):
        self.data_bits = None        # service+psdu+tail+pad, pre-scramble
        self.scrambled = None        # post-scramble, tail re-zeroed
        self.coded = None            # post-BCC (mother code)
        self.punctured = None
        self.interleaved = None
        self.data_points = None      # complex constellation points
        self.signal_bits = None      # 24 uncoded SIGNAL bits
        self.signal_points = None    # 48 BPSK points
        self.freq_symbols = None     # (1+n_sym, 64) shifted spectra
        self.samples = None          # full burst waveform


def transmit(psdu: bytes, rate_mbps: int, seed_bits=ANNEX_G_SEED) -> TxStages:
    st = TxStages()
    n_bpsc, rate, n_dbps = RATE_TABLE[rate_mbps]
    n_cbps = n_bpsc * 48
    length = len(psdu)

    n_bits = 16 + 8 * length + 6
    n_sym = -(-n_bits // n_dbps)  # ceil
    n_pad = n_sym * n_dbps - n_bits

    bits = np.concatenate([
        np.zeros(16, dtype=np.uint8),         # SERVICE (all zero)
        bytes_to_bits(psdu),
        np.zeros(6 + n_pad, dtype=np.uint8),  # tail + pad
    ])
    st.data_bits = bits
    scrambled = scramble(bits, seed_bits)
    scrambled[16 + 8 * length : 16 + 8 * length + 6] = 0  # re-zero tail
    st.scrambled = scrambled
    st.coded = conv_encode(scrambled)
    st.punctured = puncture(st.coded, rate)
    st.interleaved = interleave(st.punctured, n_bpsc, n_cbps)
    st.data_points = map_symbols(st.interleaved, n_bpsc)

    st.signal_bits = signal_field_bits(rate_mbps, length)
    sig_coded = conv_encode(st.signal_bits)
    sig_inter = interleave(sig_coded, 1, 48)
    st.signal_points = map_symbols(sig_inter, 1)

    spectra = [ofdm_symbol_freq(st.signal_points, 0)]
    for s in range(n_sym):
        spectra.append(
            ofdm_symbol_freq(st.data_points[s * 48 : (s + 1) * 48], s + 1))
    st.freq_symbols = np.stack(spectra)

    # serialize with CP16 + rolloff-2 junction blending (grc:406-424): each
    # 80-sample block k starts at 0.5*(own first CP sample + previous
    # symbol's cyclic continuation); one extra half-amplitude tail sample.
    time_syms = [time_symbol(sp) for sp in st.freq_symbols]
    # the whole burst (preamble included) is symbols of 80 with blending;
    # serializing the preamble's four 64-sample "sync words" through the
    # same CP pass reconstructs the standard 320-sample preamble exactly
    pre_syms = [time_symbol(STF_FREQ), time_symbol(STF_FREQ),
                np.roll(time_symbol(LTF_FREQ), 16), time_symbol(LTF_FREQ)]
    all_syms = pre_syms + time_syms
    out = np.zeros(80 * len(all_syms) + 1, dtype=np.complex128)
    for k, sym in enumerate(all_syms):
        blk = np.concatenate([sym[48:], sym])  # CP16 via the tail 16...
        out[k * 80 : (k + 1) * 80] = blk
        first = 0.5 * sym[48]
        if k > 0:
            first += 0.5 * all_syms[k - 1][0]
        out[k * 80] = first
    out[-1] = 0.5 * all_syms[-1][0]
    st.samples = out
    return st
