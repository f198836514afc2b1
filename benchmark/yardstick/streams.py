"""The receiver cells' traffic: multi-channel sample streams from a seed.

One general generator reads a traffic file's parameters:

  mcs, psdu_lengths     the (rate, length) combinations of the frames;
  pool_per_combo        distinct frames made per combination by the
                        vectorised TX (random PSDU bytes, scrambler seeds
                        1..127), each placed many times;
  placement             "back_to_back": every combination
                        ``per_combo_per_channel`` times on each channel in
                        a shuffled order, starting at ``lead``, gaps drawn
                        from ``gap`` (samples, inclusive); "per_block":
                        ``per_block`` frames in each block of each channel,
                        one in each equal part of the block at a drawn
                        offset; combinations drawn in turn;
  amplitude, snr_db     each burst scaled by ``amplitude`` (unit-power
                        OFDM), complex AWGN at ``snr_db`` below the burst
                        power over the whole stream;
  cfo_ppm, carrier_hz,  each frame rotated by its own offset, drawn
  sample_rate_hz        uniformly from +-cfo_ppm of the carrier, and a
                        uniform starting phase;
  streams               distinct streams a run makes and cycles through.

Every seed gives the same set of frame sizes; the order, the gaps, the
bytes, the offsets and the noise change with it. The truth of each stream
(channel, first preamble sample, rate, length, CFO in rad/sample, pool
entry) is what the receiver is held to. NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from yardstick import vtx


@dataclasses.dataclass
class Pool:
    """Distinct frames by (mcs, length): PSDUs (P, L) uint8, bursts (P, n)
    complex64 and data points (P, n_sym, 48) complex64."""

    psdus: dict
    bursts: dict
    points: dict


@dataclasses.dataclass
class Stream:
    """One (C, N) complex64 stream and the truth of its frames, one entry
    a frame in arrays of equal length."""

    x: np.ndarray
    channel: np.ndarray
    start: np.ndarray
    mcs: np.ndarray
    length: np.ndarray
    cfo: np.ndarray          # rad/sample
    entry: np.ndarray        # index into the pool's (mcs, length) entries

    @property
    def frames(self) -> int:
        return int(self.start.size)

    def psdu(self, pool: Pool, i: int) -> np.ndarray:
        return pool.psdus[(int(self.mcs[i]), int(self.length[i]))][int(self.entry[i])]


def combos(traffic: dict) -> list[tuple[int, int]]:
    return [(int(m), int(n)) for n in traffic["psdu_lengths"] for m in traffic["mcs"]]


def make_pool(traffic: dict, rng: np.random.Generator) -> Pool:
    p = int(traffic["pool_per_combo"])
    pool = Pool({}, {}, {})
    for mcs, length in combos(traffic):
        psdus = rng.integers(0, 256, (p, length), dtype=np.uint8)
        bursts, points = vtx.transmit(psdus, mcs, rng.integers(1, 128, p))
        pool.psdus[(mcs, length)] = psdus
        pool.bursts[(mcs, length)] = bursts.astype(np.complex64)
        pool.points[(mcs, length)] = points.astype(np.complex64)
    return pool


def _layout(traffic: dict, channels: int, n: int, block: int, rng) -> list:
    """[(channel, start, mcs, length)] of one stream."""
    place, cs = traffic["placement"], combos(traffic)
    out = []
    for ch in range(channels):
        if place["mode"] == "back_to_back":
            order = np.repeat(np.arange(len(cs)), int(place["per_combo_per_channel"]))
            order = rng.permutation(order)
            lo, hi = place["gap"]
            gaps = rng.integers(lo, hi + 1, order.size)
            pos = int(place["lead"])
            for k, g in zip(order, gaps):
                out.append((ch, pos) + cs[k])
                pos += vtx.burst_len(*cs[k]) + int(g)
            if pos - int(gaps[-1]) > n - int(place["tail_margin"]):
                raise ValueError(f"{order.size} frames do not fit a channel of {n} samples")
        elif place["mode"] == "per_block":
            per = int(place["per_block"])
            part = block // per
            k = 0
            for b in range(n // block):
                for j in range(per):
                    mcs, length = cs[k % len(cs)]
                    k += 1
                    room = part - vtx.burst_len(mcs, length) - 2 * int(place["margin"])
                    if room <= 0:
                        raise ValueError(f"a frame of {length} bytes at MCS {mcs} does "
                                         f"not fit 1/{per} of a {block}-sample block")
                    out.append((ch, b * block + j * part + int(place["margin"])
                                + int(rng.integers(0, room)), mcs, length))
        else:
            raise ValueError(f"unknown placement {place['mode']!r}")
    return out


def make_stream(traffic: dict, pool: Pool, channels: int, n: int, block: int,
                rng: np.random.Generator) -> Stream:
    frames = _layout(traffic, channels, n, block, rng)
    f = len(frames)
    ch = np.array([fr[0] for fr in frames], np.int64)
    start = np.array([fr[1] for fr in frames], np.int64)
    mcs = np.array([fr[2] for fr in frames], np.int64)
    length = np.array([fr[3] for fr in frames], np.int64)
    cycles = (rng.uniform(-1.0, 1.0, f) * traffic["cfo_ppm"] * 1e-6
              * traffic["carrier_hz"] / traffic["sample_rate_hz"])
    cfo = 2.0 * np.pi * cycles
    phase0 = rng.uniform(0.0, 2.0 * np.pi, f)
    entry = rng.integers(0, int(traffic["pool_per_combo"]), f)
    amp = float(traffic["amplitude"])
    sigma = np.sqrt(amp * amp * 10.0 ** (-traffic["snr_db"] / 10.0) / 2.0)
    x = rng.standard_normal((channels, 2 * n), dtype=np.float32)
    x *= np.float32(sigma)
    x = x.view(np.complex64)                                  # (C, N) noise
    for i in range(f):
        burst = pool.bursts[(int(mcs[i]), int(length[i]))][entry[i]]
        k = np.arange(burst.size)
        rot = np.exp(1j * (phase0[i] + cfo[i] * k)) * amp
        x[ch[i], start[i]: start[i] + burst.size] += (burst * rot).astype(np.complex64)
    return Stream(x=x, channel=ch, start=start, mcs=mcs, length=length, cfo=cfo, entry=entry)


def make_streams(traffic: dict, channels: int, n: int, block: int, seed: int):
    """(pool, [Stream] * traffic["streams"]) from ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x51]))
    pool = make_pool(traffic, rng)
    return pool, [make_stream(traffic, pool, channels, n, block, rng)
                  for _ in range(int(traffic["streams"]))]
