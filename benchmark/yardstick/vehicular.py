"""The ITS-G5 cell's traffic: four-channel 802.11p streams through a
doubly-selective vehicular channel, from a seed.

A traffic file's parameters:

  mcs_frames            {mcs: frames of each PSDU length a channel}: every
                        seed places the same set of frame sizes;
  psdu_lengths          the PSDU lengths;
  pool_per_combo        distinct frames made per (rate, length) by the
                        vectorised TX (random PSDU bytes, scrambler seeds
                        1..127), each placed many times;
  busy_share, lead,     the frames of a channel in a shuffled order from
  tail_margin           ``lead`` on, with gaps drawn uniformly in [1/2, 3/2]
                        of their mean and scaled so that the bursts fill
                        ``busy_share`` of the span they take; that span
                        must end ``tail_margin`` before the stream does;
  amplitude, snr_db     each burst scaled by ``amplitude`` (unit-power
                        OFDM) before the channel, whose mean power gain is
                        1; complex AWGN ``snr_db`` below the mean burst
                        power over the whole stream;
  cfo_ppm, carrier_hz,  each frame rotated by its own offset, drawn
  sample_rate_hz        uniformly from +-cfo_ppm of the carrier, and a
                        uniform starting phase;
  channel               the vehicular channel (below);
  streams               distinct streams a run makes and cycles through.

The channel is a tapped delay line at the sample rate: ``taps`` taps with
an exponential power-delay profile whose rms delay spread is
``rms_delay_s`` (``profile``). Each tap is an independent Rayleigh
process by Clarke's model, a sum of ``sinusoids`` sinusoids with uniform
angles of arrival and phases at the maximum Doppler ``doppler_hz``,
drawn afresh for every frame. The gains are evaluated exactly every
``gain_step`` samples and linearly interpolated between; the output at
sample n is sum_k g_k(n) x(n - k). A frame's first preamble sample on tap
0 is its truth start.

The truth of each stream is ``streams.Stream``'s (channel, start, rate,
length, CFO in rad/sample, pool entry); ``noise_sigma`` is the noise's
standard deviation a real axis. NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from yardstick import streams, vtx


@dataclasses.dataclass
class Stream(streams.Stream):
    noise_sigma: float = 0.0


def combos(traffic: dict) -> list[tuple[int, int]]:
    return [(int(m), int(n)) for n in traffic["psdu_lengths"] for m in traffic["mcs_frames"]]


def profile(taps: int, rms_delay_s: float, sample_rate_hz: float) -> np.ndarray:
    """(taps,) tap powers summing to 1, exp(-k / d) for the decay d (in
    samples) at which the profile's own rms delay spread is
    ``rms_delay_s``."""
    want = rms_delay_s * sample_rate_hz
    k = np.arange(taps, dtype=np.float64)

    def rms(d):
        p = np.exp(-k / d)
        p /= p.sum()
        mean = (p * k).sum()
        return np.sqrt((p * k * k).sum() - mean * mean)

    lo, hi = 1e-3, 1e3
    if not rms(lo) < want < rms(hi):
        raise ValueError(f"no exponential profile of {taps} taps has an rms delay of "
                         f"{want} samples")
    for _ in range(200):
        mid = np.sqrt(lo * hi)
        lo, hi = (mid, hi) if rms(mid) < want else (lo, mid)
    p = np.exp(-k / np.sqrt(lo * hi))
    return p / p.sum()


def tap_gains(rng: np.random.Generator, powers: np.ndarray, n: int, ch: dict,
              sample_rate_hz: float) -> np.ndarray:
    """(n, taps) complex64 gains of one frame's channel at samples 0..n-1:
    Clarke's sum of sinusoids for each tap every ``gain_step`` samples
    (each sinusoid's phasor advanced by its step's rotation, a float64
    product) and linear in between."""
    taps, m, step = powers.size, int(ch["sinusoids"]), int(ch["gain_step"])
    theta = rng.uniform(0.0, 2.0 * np.pi, (taps, m))
    phi = rng.uniform(0.0, 2.0 * np.pi, (taps, m))
    w = 2.0 * np.pi * float(ch["doppler_hz"]) * np.cos(theta) / sample_rate_hz   # rad/sample
    grid = -(-n // step) + 1                                   # samples 0, step, 2 step, ...
    z = np.empty((grid, taps, m), np.complex128)
    z[0] = np.exp(1j * phi)
    z[1:] = np.exp(1j * w * step)                              # one step's rotation
    g = (np.cumprod(z, axis=0).sum(-1) * np.sqrt(powers / m)).astype(np.complex64)
    f = (np.arange(step, dtype=np.float32) / np.float32(step))[None, :, None]
    out = g[:-1, None] + f * (g[1:, None] - g[:-1, None])      # (grid - 1, step, taps)
    return out.reshape(-1, taps)[:n]


def fade(burst: np.ndarray, gains: np.ndarray) -> np.ndarray:
    """The burst through the time-varying tapped delay line: (n + taps -
    1,) with y[n] = sum_k gains[n, k] burst[n - k]; ``gains`` covers the
    output's samples."""
    taps = gains.shape[1]
    y = np.zeros(burst.size + taps - 1, np.complex64)
    for k in range(taps):
        y[k: k + burst.size] += gains[k: k + burst.size, k] * burst
    return y


def _layout(traffic: dict, n: int, rng) -> list:
    """[(start, mcs, length)] of one channel."""
    cs = combos(traffic)
    counts = [int(traffic["mcs_frames"][str(m)]) for m, _ in cs]
    order = rng.permutation(np.repeat(np.arange(len(cs)), counts))
    lens = np.array([vtx.burst_len(*cs[k]) for k in order])
    busy = int(lens.sum())
    span = int(busy / float(traffic["busy_share"]))
    if int(traffic["lead"]) + span > n - int(traffic["tail_margin"]):
        raise ValueError(f"{order.size} frames at a busy share of {traffic['busy_share']} "
                         f"need {span} samples; a channel has {n}")
    raw = rng.uniform(0.5, 1.5, order.size)
    gaps = np.floor(raw * (span - busy) / raw.sum()).astype(np.int64)
    starts = int(traffic["lead"]) + np.concatenate([[0], np.cumsum(lens + gaps)[:-1]])
    return [(int(s), *cs[k]) for s, k in zip(starts, order)]


def make_stream(traffic: dict, pool: streams.Pool, channels: int, n: int,
                rng: np.random.Generator) -> Stream:
    frames = [(ch, *fr) for ch in range(channels) for fr in _layout(traffic, n, rng)]
    f = len(frames)
    ch = np.array([fr[0] for fr in frames], np.int64)
    start = np.array([fr[1] for fr in frames], np.int64)
    mcs = np.array([fr[2] for fr in frames], np.int64)
    length = np.array([fr[3] for fr in frames], np.int64)
    fs = float(traffic["sample_rate_hz"])
    cycles = rng.uniform(-1.0, 1.0, f) * traffic["cfo_ppm"] * 1e-6 * traffic["carrier_hz"] / fs
    cfo = 2.0 * np.pi * cycles
    phase0 = rng.uniform(0.0, 2.0 * np.pi, f)
    entry = rng.integers(0, int(traffic["pool_per_combo"]), f)
    amp = float(traffic["amplitude"])
    sigma = float(np.sqrt(amp * amp * 10.0 ** (-traffic["snr_db"] / 10.0) / 2.0))
    x = rng.standard_normal((channels, 2 * n), dtype=np.float32)
    x *= np.float32(sigma)
    x = x.view(np.complex64)                                  # (C, N) noise
    chan = traffic["channel"]
    powers = profile(int(chan["taps"]), float(chan["rms_delay_s"]), fs)
    for i in range(f):
        burst = pool.bursts[(int(mcs[i]), int(length[i]))][entry[i]]
        k = np.arange(burst.size)
        sent = (burst * (np.exp(1j * (phase0[i] + cfo[i] * k)) * amp)).astype(np.complex64)
        y = fade(sent, tap_gains(rng, powers, burst.size + powers.size - 1, chan, fs))
        x[ch[i], start[i]: start[i] + y.size] += y
    return Stream(x=x, channel=ch, start=start, mcs=mcs, length=length, cfo=cfo, entry=entry,
                  noise_sigma=sigma)


def make_streams(traffic: dict, channels: int, n: int, block: int, seed: int):
    """(pool, [Stream] * traffic["streams"]) from ``seed``; ``block`` is
    unused (the layout spans the whole channel)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7E]))
    pool = streams.make_pool({**traffic, "mcs": [int(m) for m in traffic["mcs_frames"]]}, rng)
    return pool, [make_stream(traffic, pool, channels, n, rng)
                  for _ in range(int(traffic["streams"]))]
