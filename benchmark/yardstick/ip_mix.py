"""The WLAN cell's traffic: four-channel 802.11a/g streams of IP traffic, a
rate and a length drawn for every frame, from a seed.

A traffic file's parameters:

  imix                  [[weight, low, high], ...]: each frame's IP packet
                        length is drawn from one part, chosen by weight,
                        uniformly over low..high bytes (inclusive);
  overhead              bytes the MPDU adds to the IP packet, so the PSDU
                        is the IP length plus this;
  mcs                   the rates, one drawn uniformly for every frame;
  lead, gap,            each channel's frames back to back from ``lead``
  tail_margin           on, gaps drawn uniformly from ``gap`` (samples,
                        inclusive), until the next frame would end less
                        than ``tail_margin`` before the stream does;
  amplitude, snr_db,    as in streams.py: each burst scaled by
  cfo_ppm, carrier_hz,  ``amplitude``, complex AWGN ``snr_db`` below it,
  sample_rate_hz        each frame rotated by its own offset from
                        +-cfo_ppm of the carrier and a uniform phase;
  streams               distinct streams a run makes and cycles through.

Every frame has its own random PSDU bytes and scrambler seed. The bursts
come from ``transmit``, a variable-length form of ``vtx.transmit`` for
frames of one rate and one data-symbol count: the same operations, with
each frame's PSDU, tail and SIGNAL length placed by its own length
(test_benchmark_wlan.py holds it sample for sample against
``vtx.transmit``). The truth is ``streams.Stream``'s, and the pool is
``streams.Pool``'s, keyed by (rate, length) with one entry a frame that
has that pair. NumPy only.
"""

from __future__ import annotations

import numpy as np

from yardstick import oracle_modem as om
from yardstick import streams, vtx


def psdu_lengths(traffic: dict, rng: np.random.Generator, count: int) -> np.ndarray:
    """``count`` PSDU lengths: an IP length from the imix, plus the
    overhead."""
    parts = np.asarray(traffic["imix"], np.int64)
    w = parts[:, 0] / parts[:, 0].sum()
    which = rng.choice(len(parts), size=count, p=w)
    ip = rng.integers(parts[which, 1], parts[which, 2] + 1)
    return ip + int(traffic["overhead"])


def _signal_points(mcs: int, length: int) -> np.ndarray:
    sig = om.signal_field_bits(vtx.MCS_MBPS[mcs], int(length))
    return om.map_symbols(om.interleave(om.conv_encode(sig), 1, 48), 1)


def transmit(psdus: list, mcs: int, seeds: np.ndarray):
    """Frames of one rate whose lengths give one data-symbol count: [(L_i,)
    uint8] PSDUs with (F,) scrambler seeds 1..127 -> (bursts (F,
    burst_len) complex128, data points (F, n_sym, 48)). Row i is
    ``vtx.transmit(psdus[i][None], mcs, seeds[i:i+1])``."""
    lengths = np.array([p.size for p in psdus], np.int64)
    ns = vtx.n_sym(mcs, int(lengths.max()))
    if any(vtx.n_sym(mcs, int(n)) != ns for n in lengths):
        raise ValueError("transmit: the frames' lengths give different symbol counts")
    f, lmax = lengths.size, int(lengths.max())
    n_bpsc, rate, n_dbps = om.RATE_TABLE[vtx.MCS_MBPS[mcs]]
    n_cbps = 48 * n_bpsc
    n_bits = ns * n_dbps
    padded = np.zeros((f, lmax), np.uint8)
    for i, p in enumerate(psdus):
        padded[i, : p.size] = p
    pos = np.arange(n_bits)[None, :]
    end = 16 + 8 * lengths[:, None]                         # each frame's tail starts here
    bits = np.zeros((f, n_bits), np.uint8)
    bits[:, 16: 16 + 8 * lmax] = np.unpackbits(padded, axis=1, bitorder="little")
    bits[pos >= end] = 0
    scrambled = bits ^ vtx._scrambler(np.asarray(seeds), n_bits)
    scrambled[(pos >= end) & (pos < end + 6)] = 0
    punct = vtx._puncture(vtx._conv_encode(scrambled), rate)
    perm = vtx._interleave_perm(n_cbps, n_bpsc)
    inter = punct.reshape(f, ns, n_cbps)[:, :, perm].reshape(f, -1)
    points = vtx._map(inter, n_bpsc).reshape(f, ns, 48)

    sig_points = np.stack([_signal_points(mcs, int(n)) for n in lengths])[:, None]
    spec = np.concatenate([vtx.spectra(sig_points, 0), vtx.spectra(points, 1)], axis=1)
    syms = np.concatenate([np.broadcast_to(vtx._PRE_SYMS, (f,) + vtx._PRE_SYMS.shape),
                           vtx._time(spec)], axis=1)                   # (F, K, 64)
    k = syms.shape[1]
    blocks = np.concatenate([syms[:, :, 48:], syms], axis=-1)          # CP16 + symbol
    blocks[:, :, 0] = 0.5 * syms[:, :, 48]
    blocks[:, 1:, 0] += 0.5 * syms[:, :-1, 0]
    out = np.empty((f, vtx.SYM * k + 1), np.complex128)
    out[:, :-1] = blocks.reshape(f, -1)
    out[:, -1] = 0.5 * syms[:, -1, 0]
    return out, points


def _layout(traffic: dict, n: int, rng: np.random.Generator):
    """(start, mcs, length) arrays of one channel's frames."""
    per = 4 * n // 1000 + 16                # more draws than a channel can hold
    mcs = rng.choice(np.asarray(traffic["mcs"], np.int64), size=per)
    length = psdu_lengths(traffic, rng, per)
    lo, hi = traffic["gap"]
    gaps = rng.integers(int(lo), int(hi) + 1, per)
    bursts = np.array([vtx.burst_len(int(m), int(ln)) for m, ln in zip(mcs, length)])
    start = int(traffic["lead"]) + np.concatenate([[0], np.cumsum(bursts + gaps)[:-1]])
    keep = start + bursts <= n - int(traffic["tail_margin"])
    if keep.all():
        raise ValueError("ip_mix: the draws fill less than a channel")
    k = int(np.argmin(keep))                # the frames before the first that ends too late
    return start[:k], mcs[:k], length[:k]


def make_streams(traffic: dict, channels: int, n: int, block: int, seed: int):
    """(pool, [streams.Stream] * traffic["streams"]) from ``seed``; the
    pool holds every frame's PSDU and data points (no bursts)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x1B]))
    amp = float(traffic["amplitude"])
    sigma = np.sqrt(amp * amp * 10.0 ** (-traffic["snr_db"] / 10.0) / 2.0)
    psdus: dict = {}
    points: dict = {}
    out = []
    for _ in range(int(traffic["streams"])):
        lay = [_layout(traffic, n, rng) for _ in range(channels)]
        ch = np.concatenate([np.full(s.size, c, np.int64) for c, (s, _, _) in enumerate(lay)])
        start = np.concatenate([s for s, _, _ in lay])
        mcs = np.concatenate([m for _, m, _ in lay])
        length = np.concatenate([ln for _, _, ln in lay])
        f = start.size
        cycles = (rng.uniform(-1.0, 1.0, f) * traffic["cfo_ppm"] * 1e-6
                  * traffic["carrier_hz"] / traffic["sample_rate_hz"])
        cfo = 2.0 * np.pi * cycles
        phase0 = rng.uniform(0.0, 2.0 * np.pi, f)
        seeds = rng.integers(1, 128, f)
        frames = [rng.integers(0, 256, int(ln), dtype=np.uint8) for ln in length]
        entry = np.empty(f, np.int64)
        x = rng.standard_normal((channels, 2 * n), dtype=np.float32)
        x *= np.float32(sigma)
        x = x.view(np.complex64)                                  # (C, N) noise
        ns = np.array([vtx.n_sym(int(m), int(ln)) for m, ln in zip(mcs, length)])
        group = mcs * 4096 + ns
        for g in np.unique(group):
            idx = np.flatnonzero(group == g)
            m = int(mcs[idx[0]])
            bursts, pts = transmit([frames[i] for i in idx], m, seeds[idx])
            for row, i in enumerate(idx):
                key = (m, int(length[i]))
                entry[i] = len(psdus.setdefault(key, []))
                psdus[key].append(frames[i])
                points.setdefault(key, []).append(pts[row].astype(np.complex64))
                k = np.arange(bursts.shape[1])
                rot = np.exp(1j * (phase0[i] + cfo[i] * k)) * amp
                x[ch[i], start[i]: start[i] + k.size] += (bursts[row] * rot).astype(np.complex64)
        out.append(streams.Stream(x=x, channel=ch, start=start, mcs=mcs, length=length,
                                  cfo=cfo, entry=entry))
    pool = streams.Pool(psdus={k: np.stack(v) for k, v in psdus.items()}, bursts={},
                        points={k: np.stack(v) for k, v in points.items()})
    return pool, out
