"""The scenarios that the port's on-card runs and their CPU twins share.

``chip_smoke.py``, ``multichip_torch.py`` and the tests build their
traffic from here, so that each scenario has one definition:

    the bench shapes     ``bench.py``'s device_step shape (BLOCK,
                         TIME_BLOCKS, CHANNELS, MAX_FRAMES), its adaptive
                         shape (ADAPTIVE_SHARDS, ADAPTIVE_SLOTS) and the
                         frames they carry (MCS, PSDU_LEN);
    streams              ``make_stream`` (port-TX bursts in seeded noise),
                         ``adaptive_stream`` (``bench.py``'s frames/s
                         traffic), ``seam_positions`` (frames across block
                         seams), ``fft_oversample`` and
                         ``sample_clock_offset`` (captures at other rates);
    the small step       SMALL_* (the tolerances of a small-geometry
                         training step held against another device or
                         another layout);
    the PER waterfall    ``waterfall_inputs``, ``waterfall_tables``,
                         ``frame_errors`` and ``waterfall_failures``
                         (tests/test_waterfall.py's points, channel and
                         assertions, noise drawn in numpy);
    the Mode-2 soak      ``run_soak`` through ``LossyRelay``
                         (tests/test_soak.py through the port).

The JAX package keeps its waterfall and soak in its tests; the port keeps
them here so that the smoke run and the tests run one harness. Nothing is
built, opened or queried when this module is imported.
"""

from __future__ import annotations

import pathlib
import socket
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

MCS = 2
PSDU_LEN = 50
# the bench's device_step shape (bench.py: BLOCK, TIME_BLOCKS, CHANNELS)
BLOCK = 1 << 18
TIME_BLOCKS = 16
CHANNELS = 4
MAX_FRAMES = 4
FRAMES_PER_BLOCK = 3
# the bench's adaptive shape (bench.py: BLOCK, DENSE_BLOCKS,
# DENSE_MAX_FRAMES): one channel of 4 blocks, 128 slots a block, sc8
ADAPTIVE_SHARDS = 4
ADAPTIVE_SLOTS = 128
MAC_PAYLOAD = PSDU_LEN - 28          # + MAC header and FCS = a 50-byte PSDU
# the fixed mesh stream holds MESH_SUPERBLOCKS super-blocks of the bench
# shape (3 overlapping strides)
MESH_SUPERBLOCKS = 2

# a small-geometry m2m step (80 x 80, c = 64) held against the same step
# on another device or layout. Tolerances: the loss within 1e-4 relative;
# each gradient leaf within 1e-3 of its largest value (1e-7 absolute at
# least: a conv bias before BatchNorm has a gradient of rounding noise);
# parameters within 2 lr + 1e-6 a step (Adam's first step sends a leaf by
# about lr whatever its gradient's size, so a noise gradient of the other
# sign lands 2 lr away); batch statistics within 1e-5
SMALL_LR = 1e-3
SMALL_LOSS_RTOL, SMALL_GRAD_RTOL, SMALL_GRAD_ATOL, SMALL_STATS_ATOL = 1e-4, 1e-3, 1e-7, 1e-5

# the PER waterfall of tests/test_waterfall.py, genie-aligned through
# rx.decode_aligned. AWGN: WATERFALL_FRAMES frames of WATERFALL_PSDU bytes
# an MCS at the SNRs of tests/test_waterfall.py:38-57 and one point in
# each MCS's falling edge; fading: :80's table at full size (its 3-tap
# wandering channel). Noise is drawn in numpy, one unit-power draw a
# table scaled to each SNR.
WATERFALL_FRAMES = 16
WATERFALL_PSDU = 100
# (the edge points: where the port's CPU path, 1 dB apart from -3 to 30 dB,
# loses 3 to 10 of the 16 frames)
WATERFALL_SNRS = {0: (-2.0, 1.0, 8.0, 10.0), 1: (3.0,), 2: (4.0,),
                  3: (2.0, 4.0, 6.0, 10.0, 14.0, 18.0), 4: (9.0,), 5: (12.0,), 6: (16.0,),
                  7: (10.0, 14.0, 17.0, 26.0)}
FADING = {"frames": 16, "psdu": 400, "mcs": 5, "snrs": (15.0, 25.0, 35.0),
          "algos": ("LS", "LMS", "COMB", "STA")}
# tests/test_soak.py at full scale: kodim07 at 300 x 300 (2 700 pieces a
# lap), 8 % of the sender's datagrams dropped, the canvas bit-exact
SOAK_SIZE = 300
SOAK_DROP = 0.08
SOAK_TIMEOUT_S = 600.0


# Streams
# ----------------------------------------------------------------------


def make_stream(tx, n: int, positions, n_frames: int, rng, device):
    """One channel: n_frames port-TX bursts at positions in seeded noise."""
    frames = rng.integers(0, 256, (n_frames, PSDU_LEN), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=device).cpu().numpy()
    x = np.zeros(n, np.complex64)
    for pos, b in zip(positions, bursts):
        x[pos: pos + b.size] += 0.5 * b
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x.astype(np.complex64), frames


def adaptive_stream(tx, mac, mcs, n: int, rng, device):
    """bench.py's frames/s traffic, one channel of n samples: 50-byte
    PSDUs back to back at spacing max(burst + 500, block/128 + 1) in noise
    0.01, made by the port's TX on the card. mcs: one rate (a dense
    stream), or None for the mixed stream, which rotates through the 8
    rates frame by frame and carries MPDUs (22-byte payloads framed by
    mac.frame_batch). Returns ((1, n) stream, (F, 50) PSDUs, (F,) rates)."""
    rates = [mcs] if mcs is not None else list(range(8))
    burst = max(tx.tx_plan(m, PSDU_LEN).n_samples for m in rates)
    spacing = max(burst + 500, BLOCK // ADAPTIVE_SLOTS + 1)
    positions = np.arange(300, n - burst - 800, spacing)
    mcs_seq = np.arange(positions.size) % len(rates) if mcs is None else np.full(
        positions.size, mcs)
    if mcs is None:
        psdus = mac.frame_batch(rng.integers(0, 256, (positions.size, MAC_PAYLOAD),
                                             dtype=np.uint8))
    else:
        psdus = rng.integers(0, 256, (positions.size, PSDU_LEN), dtype=np.uint8)
    x = np.zeros(n, np.complex64)
    for m in rates:
        sel = np.flatnonzero(mcs_seq == m)
        bursts = tx.transmit(psdus[sel], m, scrambler_seed=torch.from_numpy(sel % 127 + 1),
                             device=device).cpu().numpy()
        for pos, b in zip(positions[sel], bursts):
            x[pos: pos + b.size] += 0.5 * b
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x[None].astype(np.complex64), psdus, mcs_seq


def seam_positions(n: int, block: int) -> list[int]:
    """Frame positions of the fixed mesh stream: one burst across each block
    seam (its edge 700 samples before it, across the super-block strides'
    seams too), one inside each block, one flush against the stream end."""
    pos = []
    for b in range(1, n // block):
        pos += [b * block - block // 2, b * block - 700]
    return pos + [n - block // 2, n - 1900]


def fft_oversample(x, m: int):
    """Exact m-times oversampling along the last axis by FFT zero padding
    (periodic), of a complex64 torch tensor on its device."""
    n = x.shape[-1]
    spec = torch.fft.fft(x)
    up = torch.zeros(x.shape[:-1] + (m * n,), dtype=spec.dtype, device=x.device)
    h = n // 2
    up[..., :h] = spec[..., :h]
    up[..., -h:] = spec[..., -h:]
    return torch.fft.ifft(up) * m


def sample_clock_offset(x: np.ndarray, ppm: float, n_taps: int = 16,
                        chunk: int = 1 << 19) -> np.ndarray:
    """numpy copy of the JAX package's channel/model.py sample_clock_offset
    (a clock running (1 + ppm*1e-6) fast, y[m] = x(m (1 + ppm*1e-6)) by
    Hann-windowed-sinc interpolation), with float64 positions, in chunks."""
    delta = ppm * 1e-6
    n = x.shape[-1]
    n_out = int(n / max(1.0 + delta, 1e-9)) - n_taps
    k = np.arange(-(n_taps // 2 - 1), n_taps // 2 + 1)
    y = np.empty(n_out, np.complex64)
    for lo in range(0, n_out, chunk):
        t = np.arange(lo, min(lo + chunk, n_out)) * (1.0 + delta)
        base = np.floor(t).astype(np.int64)
        frac = (t - base).astype(np.float32)
        idx = np.clip(base[:, None] + k[None, :], 0, n - 1)
        arg = k[None, :].astype(np.float32) - frac[:, None]
        w = np.sinc(arg) * (0.5 + 0.5 * np.cos(np.pi * arg / (n_taps // 2 + 1)))
        w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        y[lo: lo + t.size] = (x[idx] * w).sum(-1)
    return y


# The PER waterfall
# ----------------------------------------------------------------------


def unit_noise(shape, seed: int) -> np.ndarray:
    """Complex white Gaussian noise of unit power (per-component std
    1/sqrt(2)), complex128, from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)


def at_snr(bursts: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """Unit-power bursts plus noise of voltage 10^(-snr/20), complex64
    (tests/test_waterfall.py:29-31's convention)."""
    return (bursts + 10 ** (-snr_db / 20) * noise).astype(np.complex64)


def fading_burst(burst: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """tests/test_waterfall.py:61's slowly time-varying 3-tap channel, per
    sample: tap gains wander smoothly with periods of about 80-130 symbols."""
    n = burst.size
    delays = np.array([0, 3, 7])
    g0 = np.array([1.0, 0.45, 0.3]) * np.exp(2j * np.pi * rng.random(3))
    periods = np.array([80.0, 102.4, 128.8]) * 80.0        # symbols -> samples
    t = np.arange(n)[:, None]
    wob = np.exp(1j * (2 * np.pi * t / periods + 2 * np.pi * rng.random(3)))
    gains = g0 * (1 + 0.5 * (wob - wob[0]))                # (n, 3); H(0)=H0
    y = np.zeros(n, dtype=np.complex128)
    for d, gd in zip(delays, gains.T):
        y[d:] += gd[d:] * burst[: n - d]
    return y.astype(np.complex64)


def waterfall_inputs(transmit, snrs=WATERFALL_SNRS, fading=FADING) -> dict:
    """The waterfall's numpy inputs from seeds: the frames (rng 0, as
    tests/test_waterfall.py), their bursts by ``transmit(psdu, mcs, seeds)``
    (numpy complex64, scrambler seeds 1..n) and unit noise.
    {"awgn": {mcs: (psdu, bursts, noise)}, "fading": (psdu, faded, noise)}."""
    out = {"awgn": {}}
    for mcs in snrs:
        psdu = np.random.default_rng(0).integers(0, 256, (WATERFALL_FRAMES, WATERFALL_PSDU),
                                                 dtype=np.uint8)
        bursts = transmit(psdu, mcs, np.arange(1, WATERFALL_FRAMES + 1))
        out["awgn"][mcs] = (psdu, bursts, unit_noise(bursts.shape, 1000 + mcs))
    n = fading["frames"]
    psdu = np.random.default_rng(0).integers(0, 256, (n, fading["psdu"]), dtype=np.uint8)
    bursts = transmit(psdu, fading["mcs"], np.arange(1, n + 1))
    faded = np.stack([fading_burst(b, np.random.default_rng(100 + i))
                      for i, b in enumerate(bursts)])
    out["fading"] = (psdu, faded, unit_noise(faded.shape, 7))
    return out


def waterfall_tables(inputs: dict, decode, snrs=WATERFALL_SNRS, fading=FADING) -> dict:
    """``decode(y, mcs, psdu_len, algo)`` (a dict of numpy arrays with
    "psdu") at every point: {("awgn", mcs, snr) and ("fading", algo, snr):
    its result}. AWGN points are equalized by LS."""
    out = {}
    for mcs, points in snrs.items():
        psdu, bursts, noise = inputs["awgn"][mcs]
        for snr in points:
            out[("awgn", mcs, snr)] = decode(at_snr(bursts, noise, snr), mcs, psdu.shape[1], "LS")
    psdu, faded, noise = inputs["fading"]
    for algo in fading["algos"]:
        for snr in fading["snrs"]:
            out[("fading", algo, snr)] = decode(at_snr(faded, noise, snr), fading["mcs"],
                                                psdu.shape[1], algo)
    return out


def frame_errors(tables: dict, inputs: dict) -> dict:
    """{point: (frames,) bool, the frames whose bytes differ from those sent}."""
    def sent(key):
        return inputs["awgn"][key[1]][0] if key[0] == "awgn" else inputs["fading"][0]

    return {k: (v["psdu"] != sent(k)).any(axis=1) for k, v in tables.items()}


def waterfall_failures(per: dict) -> list[str]:
    """tests/test_waterfall.py's assertions on a table of PERs: the
    regimes, the rate ladder, monotone PER over SNR (MCS 3), and, where
    the table has its fading points, LS's floor with LMS and STA under it
    and COMB near it. Returns the assertions that fail."""
    bad = []

    def need(cond, what):
        if not cond:
            bad.append(what)

    for mcs, ok, dead in ((0, 8.0, -2.0), (3, 14.0, 4.0), (7, 26.0, 14.0)):
        if ("awgn", mcs, ok) in per:
            need(per[("awgn", mcs, ok)] == 0.0, f"MCS{mcs} clean at {ok} dB")
            need(per[("awgn", mcs, dead)] > 0.5, f"MCS{mcs} fails at {dead} dB")
    if ("awgn", 7, 10.0) in per:
        need(per[("awgn", 0, 10.0)] == 0.0 and per[("awgn", 7, 10.0)] == 1.0,
             "the rate ladder at 10 dB: MCS0 clean, MCS7 dead")
    ladder = [per.get(("awgn", 3, s)) for s in (2.0, 6.0, 10.0, 14.0, 18.0)]
    if None not in ladder:
        need(all(a >= b - 0.07 for a, b in zip(ladder, ladder[1:]))
             and ladder[0] > 0.5 and ladder[-1] == 0.0, f"MCS3 monotone over SNR: {ladder}")
    if ("fading", "LS", 35.0) in per:
        ls, lms, sta, comb = (per[("fading", a, 35.0)] for a in ("LS", "LMS", "STA", "COMB"))
        need(ls >= 0.5, f"LS's fading floor at 35 dB {ls} >= 0.5")
        need(lms <= ls - 0.3, f"LMS {lms} under LS {ls} - 0.3 at 35 dB")
        need(sta <= ls - 0.25, f"STA {sta} under LS {ls} - 0.25 at 35 dB")
        need(comb >= ls - 0.15, f"COMB {comb} near LS {ls} at 35 dB")
        need(lms <= per[("fading", "LMS", 15.0)], "LMS at 35 dB no worse than at 15 dB")
    return bad


# The Mode-2 soak
# ----------------------------------------------------------------------


class LossyRelay:
    """UDP forwarder dropping SOAK_DROP of the datagrams, drawn from
    ``np.random.default_rng(0)`` (tests/test_soak.py's): loss injected
    between the sender and the radio, independent of the PHY's own CRC
    screen."""

    def __init__(self, dst_port: int):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.dst = ("127.0.0.1", dst_port)
        self.rng = np.random.default_rng(0)
        self.dropped = 0
        self.forwarded = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._t.start()
        return self

    def _run(self):
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if self.rng.random() < SOAK_DROP:
                self.dropped += 1
                continue
            out.sendto(data, self.dst)
            self.forwarded += 1
        out.close()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2.0)
        self.sock.close()


def run_soak(device, size: int = SOAK_SIZE, timeout_s: float = SOAK_TIMEOUT_S) -> dict:
    """tests/test_soak.py's Mode-2 soak through the port: kodim07 resized
    to size x size, the port's SenderApp (AppConfig, 2 ms piece spacing,
    re-sent in laps) -> LossyRelay (SOAK_DROP of the datagrams) ->
    LoopbackRadio (MCS 3, 22 dB, batch 16, on ``device``) -> ReceiverApp,
    until the canvas equals the resized image or ``timeout_s`` passes.
    Returns the record of docs/soak_mode2.md (``bit_exact`` False on a
    timeout) with the relay's and the radio's counts."""
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch.config import AppConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.apps import ReceiverApp, SenderApp
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio

    img = np.asarray(Image.open(ROOT / "assets" / "kodim07.png").convert("RGB"))
    expect = np.asarray(Image.fromarray(img).resize((size, size)), dtype=np.uint8)
    recv = ReceiverApp(cfg=AppConfig(image_size=(size, size)), http_port=0, rx_port=0)
    radio = LoopbackRadio(in_port=0, out_port=recv.rx_port, mcs=3, snr_db=22.0, batch=16,
                          device=device)
    relay = LossyRelay(dst_port=radio.in_port)
    send = SenderApp(cfg=AppConfig(image_size=(size, size), tx_port=relay.port,
                                   piece_interval_s=0.002), http_port=0)
    recv.start()
    radio.start()
    relay.start()
    t0 = time.monotonic()
    converged = None
    try:
        send.send_image(img)
        while time.monotonic() - t0 < timeout_s:
            if np.array_equal(recv.canvas, expect):
                converged = time.monotonic() - t0
                break
            time.sleep(0.05)
        laps = send.sender.laps + 1
    finally:
        send.stop()
        relay.stop()
        radio.stop()
        recv.stop()
    wall = time.monotonic() - t0
    return {
        "image": f"kodim07 {size}x{size}",
        "pieces_per_lap": size * size * 3 // 100,
        "laps_started": laps,
        "injected_drop_rate": SOAK_DROP,
        "relay_dropped": relay.dropped,
        "relay_forwarded": relay.forwarded,
        "radio_datagrams_in": radio.stats["datagrams_in"],
        "pieces_decoded": recv.pieces_received,
        "pieces_per_s": recv.pieces_received / (converged or wall),
        "frames_crc_fail": radio.stats["frames_crc_fail"],
        "converged_s": converged,
        "bit_exact": converged is not None,
        "pixels_equal": int((recv.canvas == expect).all(axis=-1).sum()),
    }
