#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py [--parent <checkout root>]
    python3 chip_smoke.py --fir-times <checkout root>

Drives the port's main paths through the entry points a user calls and
holds each hand-written kernel against its plain PyTorch version:

  1. builds the kernels from ``gnuradio_wifi_imagetransfer_tpu_torch/csrc``
     with nvcc (sm_90a) and prints the build seconds;
  2. prints the card's name and power limit (nvidia-smi);
  3. checks the dense sync-statistics kernel (K1) against its plain
     version on the executor's real blocks: one 263 840-sample row and
     the 64-row batch (atol 2e-4 on a and p, 1e-3 on c where p > 1e-3);
     then the fused STF detector (K1's redesign, ``sync_detect``) on the
     64 blocks with the executor's search bounds, on the flagship block,
     and on synthetic rows with edges at tile boundaries (991-993,
     1023-1025, 1983-1985, 2976), more than K edges in one tile and edges
     just inside and outside the search bounds: starts and valid exact,
     cfo within 1e-4
     and ratio within 1e-3 of ``sync_detect_plain``, and every field
     bit-identical to dense K1 plus the plain torch glue;
  4. checks the Viterbi kernel (K2) bit-exact against its plain version on
     256 x 422 and 256 x 24 LLRs that are random, punctured and tied, one
     segment a launch and both segments in one launch
     (``viterbi_decode_many``);
  5. checks the FIR kernel (K3) against its plain version (atol 2e-4): (2,
     300) with 5, 48, 129 and 200 taps; rows of 2047, 2048, 2049 and 4097
     samples (around the 2048-output tile) with 1, 65, 256, 257 and 1000
     taps (around the 256-tap chunk); all real and complex; (70 000,
     40), past 65 535 rows; (4, 4 194 304) complex with 65 taps; rows
     kept apart (batch isolation);
  6. checks the polyphase-resampler kernel (K4) against its plain version
     (atol 2e-4): ratios 1/2, 2/1, 3/4, 4/3, 5/2, real and complex, at
     (600,) and (2, 4, 90); rows around the 2048-output tile at 3/4, 1/2
     and 2/1; 1/96 (a smaller tile), phase rows of 16, 9 and 7000 taps
     (the generic loop, restaged passes); (70 000, 50) at 3/4; the
     full-width 3/4 front-end input (4 rows of 5.6 M samples); 25001/25000
     on (1, 1 048 576), past the int32 index range and through the phase
     table in L2, with an analytic tone within 1e-3;
  7. runs the flagship block: 4 frames (MCS 2, 50-byte PSDUs) made by the
     port's TX in a 32 768-sample block with seeded noise, through
     ``sync.receive`` with 8 slots on CUDA; all 4 frames must come back
     bit-exact and agree with the port's CPU path;
  8. runs the local ``StreamExecutor`` at the bench's device_step shape
     (4 channels x 16 blocks x 262 144 samples, sc16 wire, 4 slots, 3
     frames per block per channel); all 192 frames must come back
     bit-exact; prints the step rate timed with CUDA events and a profile;
  9. calls the stand-alone entry points: ``ops.fir_filter`` on the
     4-channel stream with a 65-tap low-pass (K3), ``sync.sync_stats`` on
     the executor's blocks (dense K1) and ``viterbi.decode`` on the
     step's payload trellises (K2, one segment);
 10. runs the same executor on a 4/3-rate capture of the same frames (FFT
     oversampled) with ``FrontendConfig(resample=(3, 4))``: the general
     front-end (K4) then the RX path; 192 of 192 frames bit-exact;
 11. the same on a 2x-oversampled capture skewed by +40 ppm with
     ``FrontendConfig(resample=(1, 2), ppm=40.0)`` (decimation and clock
     trim in torch ops); 192 of 192 frames bit-exact;
 12. times the resident front-end correction pass (CUDA events) for
     decim2, ppm40 and general 3/4 at 2**22 padded outputs, left pad 256
     (the JAX bench's shape), in input Msamples/s;
 13. times each kernel (CUDA events) beside its plain version and bound:
     dense K1, the fused detector and dense K1 plus the torch glue it
     replaces, the segmented K2 and the same trellises as two one-segment
     launches, K2's chain floor, K3 and K4 with their share of bound and
     their conv1d yardsticks, K3 with its taps given as numpy and as a
     CUDA tensor (with ``--parent``, also the other checkout's K3 and K4
     in turns with this tree's, each in a process of its own); then
     prints one JSON line of kernel timings, bounds and launch counts.

``--fir-times <checkout root>`` only times that checkout's K3 and K4 at
phase 13's shapes (three rounds of 20 calls, CUDA events) and prints one
JSON line; two checkouts are compared by running it in turns (A, B, B,
A). It builds the kernels into that checkout's own build directory.

Launch counts are set to 0 just before each main-path run (7 to 11) and
read just after; launches made to compare or time a kernel do not count.
An executor step launches the fused detector once and the segmented
Viterbi kernel once, and dense K1 not at all.
The last line of stdout is {"ok": true, "device": {...}}. Any failure
exits non-zero. Without CUDA, or without the port package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "gnuradio_wifi_imagetransfer_tpu_torch"

MCS = 2
PSDU_LEN = 50
# the bench's device_step shape (bench.py: BLOCK, TIME_BLOCKS, CHANNELS)
BLOCK = 1 << 18
TIME_BLOCKS = 16
CHANNELS = 4
MAX_FRAMES = 4
FRAMES_PER_BLOCK = 3
# the bench's front-end pass shape (bench.py: n_out_pad, left pad 256)
FE_OUT_PAD = 1 << 22
FIR_TAPS = 65

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per sample of the sync statistics in the kernels'
# addition-only form (csrc/sync_stats.cu, 8 outputs a thread): m (6),
# |x|^2 (3), the window sums of 8 outputs (the shared cores of 41 complex
# and 57 real terms 2 x 40 + 56, the suffix and running sums 2 x 3 x 7,
# 2 adds an output for each of the 3 sums 48: 226 for 8), |a| / p (5)
K1_OPS_PER_SAMPLE = 6 + 3 + 226 / 8 + 5
# the fused detector adds the threshold compare
K1_DETECT_OPS_PER_SAMPLE = K1_OPS_PER_SAMPLE + 1
# per frame and trellis step of the Viterbi ACS in the kernel's form (the
# code is linear, so a step has 4 distinct gains): 4 gains x (2 mul + 1
# add) + 64 states x 2 edges x 1 add + 64 compare/select + 63 max + 64
# subtract
K2_OPS_PER_STEP = 4 * 3 + 64 * 2 + 64 + 63 + 64
# a real tap on a complex sample: 2 multiplies + 2 adds
OPS_PER_COMPLEX_TAP = 4
# K2's chain floor, a design estimate in dependent cycles: an ACS step
# (two shared loads in flight together ~33, add 4, compare/select 8, 3
# in-lane max 12, 3 shuffles with their max ~84, subtract 4, stores and
# the warp sync ~20) and a traceback step (shared byte load ~33, bit and
# state arithmetic ~12)
K2_ACS_CYCLES = 165
K2_TRACEBACK_CYCLES = 45


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up.

    A device sleep of about 20 ms is queued ahead of the timed runs, so
    the host enqueues them while the device waits: where the host keeps
    up, the events time the device work and not the host's dispatch of a
    kernel shorter than its wrapper's call."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def fir_times(root: str) -> None:
    """Times the K3 and K4 of the port under root: fir_filter on (4, 4 194
    304) complex64 with 65 taps (numpy, then a CUDA tensor), and
    polyphase_resample at 3/4 on (4, 5 595 478) complex64 (the general
    front-end's input of phase 10) with design_lowpass(3, 4); three rounds
    of 20 calls each. Prints one JSON line."""
    import scipy.signal
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, root)
    try:
        from gnuradio_wifi_imagetransfer_tpu_torch import ops
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir
    except ImportError as e:
        fail(f"the port package {PKG} is not under {root} ({e})")
    check(os.path.abspath(fir.__file__).startswith(os.path.join(root, PKG)),
          f"{PKG} was imported from {fir.__file__}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def cplx(shape):
        v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(v.astype(np.complex64)).to(dev)

    x3, h3 = cplx((CHANNELS, 1 << 22)), scipy.signal.firwin(FIR_TAPS, 0.5).astype(np.float32)
    h3_dev = torch.from_numpy(h3).to(dev)
    x4, h4 = cplx((CHANNELS, 5_595_478)), ops.design_lowpass(3, 4)
    out = {"root": root, "fir_ms": [], "fir_device_taps_ms": [], "resample_ms": []}
    for _ in range(3):
        out["fir_ms"].append(cuda_ms(lambda: fir.fir_filter(x3, h3), 20))
        out["fir_device_taps_ms"].append(cuda_ms(lambda: fir.fir_filter(x3, h3_dev), 20))
        out["resample_ms"].append(cuda_ms(lambda: fir.polyphase_resample(x4, 3, 4, h4), 20))
    print(json.dumps(out))


def fir_times_of(root: str) -> dict:
    """fir_times(root) in a process of its own (one port package a
    process); its failure is this run's."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--fir-times", root],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"--fir-times {root} exited {r.returncode}: {r.stderr.strip()[-2000:]}")
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"--fir-times {root} printed no JSON line: {r.stdout[-2000:]}")


def max_err(got, want) -> float:
    return (got - want).abs().max().item()


def make_stream(tx, n: int, positions, n_frames: int, rng, device):
    """One channel: n_frames port-TX bursts at positions in seeded noise."""
    frames = rng.integers(0, 256, (n_frames, PSDU_LEN), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=device).cpu().numpy()
    x = np.zeros(n, np.complex64)
    for pos, b in zip(positions, bursts):
        x[pos: pos + b.size] += 0.5 * b
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x.astype(np.complex64), frames


def fft_oversample(x, m: int):
    """Exact m-times oversampling along the last axis by FFT zero padding
    (periodic), of a complex64 torch tensor on its device."""
    import torch

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


def burst_rows(n: int, edges_per_row, min_plateau: int, seed: int):
    """Rows of faint noise with 48-sample bursts of a unit-magnitude
    16-periodic signal, each placed so that its rising detection edge
    falls at the given index (c first reaches 0.56 36 samples into a
    burst: 21/37 there, 20/36 a sample before)."""
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal((len(edges_per_row), n))
                + 1j * rng.standard_normal((len(edges_per_row), n)))
    for row, edges in enumerate(edges_per_row):
        for e in edges:
            p = e - 36 - (min_plateau - 1)
            theta = rng.uniform(0, 2 * np.pi, 16)
            x[row, p: p + 48] = np.exp(1j * theta[np.arange(48) % 16])
    return x.astype(np.complex64)


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch + CUDA port.")
    ap.add_argument("--parent", help="another checkout's root: time its K3 and K4 beside "
                                     "this tree's in phase 13, in turns")
    ap.add_argument("--fir-times", metavar="ROOT",
                    help="only time the K3 and K4 of the checkout at ROOT")
    args = ap.parse_args()
    if args.fir_times:
        fir_times(os.path.abspath(args.fir_times))
        return
    parent = os.path.abspath(args.parent) if args.parent else None

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        port = __import__(PKG)
    except ImportError as e:
        fail(f"the port package {PKG} is not beside this script ({e})")
    check(os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(HERE, PKG),
          f"{PKG} was imported from {port.__file__}, not from this checkout")

    import scipy.signal

    from gnuradio_wifi_imagetransfer_tpu_torch import ops
    from gnuradio_wifi_imagetransfer_tpu_torch.config import (
        ExecutorConfig,
        FrontendConfig,
        PhyConfig,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (
        HALO_LEFT,
        corrected_resident,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.frontend import cached_frontend
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx, viterbi

    dev = torch.device("cuda")
    kernels = [k1.sync_stats, k1.sync_detect, k2.viterbi_decode, k2.viterbi_decode_many,
               k34.fir_filter, k34.polyphase_resample]
    phy = PhyConfig()
    thr, mp = phy.sync_threshold, phy.min_plateau

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in kernels}

    def check_path_launches(launches, steps, label, also=()):
        """A step launches the fused detector once and the segmented
        Viterbi kernel once, dense K1 and one-segment K2 never."""
        check(launches["sync_detect"] == steps and launches["viterbi_decode_many"] == steps
              and launches["sync_stats"] == 0 and launches["viterbi_decode"] == 0
              and all(launches[k] > 0 for k in also),
              f"{label}: launches {launches} for {steps} steps")

    def n_steps(executor, capture):
        return len(range(0, executor.effective_len(capture.shape[1]), TIME_BLOCKS * BLOCK))

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path, HERE)}")

    # -- 2. card -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)

    # the executor's stream, made first: K1 is checked on its real blocks
    rng = np.random.default_rng(0)
    n = TIME_BLOCKS * BLOCK
    n_frames = FRAMES_PER_BLOCK * TIME_BLOCKS
    gap = n // n_frames
    positions = [min(150 + i * gap, n - 2000) for i in range(n_frames)]
    streams, payloads = zip(*(make_stream(tx, n, positions, n_frames, rng, dev)
                              for _ in range(CHANNELS)))
    stream = np.stack(streams)
    cfg = ExecutorConfig(block_size=BLOCK, time_shards=TIME_BLOCKS, channels=CHANNELS,
                         max_frames_per_block=MAX_FRAMES, wire_format="sc16")
    ex = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), exec_cfg=cfg, device=dev)
    ex.stage_resident(stream)
    blocks = ex.extended_blocks(0)              # (64, 263 840) complex64
    # the flagship block (phases 3 and 7): 4 frames in 32 768 samples
    frng = np.random.default_rng(0)
    frames = frng.integers(0, 256, (4, PSDU_LEN), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=dev).cpu().numpy()
    nf = 1 << 15
    xf = np.zeros(nf, np.complex64)
    for i, b in enumerate(bursts):
        pos = min(200 + i * (nf // 4), nf - b.size - 1)
        xf[pos: pos + b.size] += 0.5 * b
    xf = (xf + 0.01 * (frng.standard_normal(nf) + 1j * frng.standard_normal(nf))
          ).astype(np.complex64)

    # the front-end captures of the same frames (phases 6, 10, 11): 4/3
    # and 2x oversampled by FFT on the card, the 2x one skewed by +40 ppm
    # on the host (one thread a channel)
    t0 = time.perf_counter()
    up4 = fft_oversample(torch.from_numpy(stream).to(dev), 4)
    cap_34 = up4[:, ::3].cpu().numpy()                  # input at 4/3 the rate
    del up4
    up2 = fft_oversample(torch.from_numpy(stream).to(dev), 2).cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(CHANNELS) as pool:
        cap_ppm = np.stack(list(pool.map(lambda row: sample_clock_offset(row, 40.0), up2)))
    del up2
    print(f"front-end captures: 3/4 {cap_34.shape}, (1/2, +40 ppm) {cap_ppm.shape} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 3. K1 against its plain version ---------------------------------
    k1_err = 0.0
    for x in (blocks[:1], blocks):
        a, p, c = k1.sync_stats(x)
        pa, pp, pc = k1.sync_stats_plain(x)
        torch.cuda.synchronize()
        mask = pp > 1e-3
        errs = [max_err(a, pa), max_err(p, pp), (c - pc).abs()[mask].max().item()]
        check(errs[0] <= 2e-4 and errs[1] <= 2e-4 and errs[2] <= 1e-3,
              f"sync_stats kernel disagrees with its plain version on "
              f"{tuple(x.shape)}: max |da|, |dp|, |dc| = {errs}")
        k1_err = max(k1_err, errs[0], errs[1])
        print(f"K1 sync_stats {tuple(x.shape)}: max |da| {errs[0]:.3g}, |dp| {errs[1]:.3g}, "
              f"|dc| {errs[2]:.3g} (atol 2e-4, 2e-4, 1e-3): ok")

    def detect_check(x, k, plateau, lo, hi, label):
        """The fused detector against its plain version and against dense
        K1 plus the plain glue; returns (max |dcfo|, max |dratio|, valid)."""
        got = k1.sync_detect(x, k, thr, plateau, lo, hi)
        want = k1.sync_detect_plain(x, k, thr, plateau, lo, hi)
        a, _, c = k1.sync_stats(x)
        glue = k1.detect_from_stats(a, c, k, thr, plateau, lo, hi)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"sync_detect != plain on {label}: starts {got[0].tolist()} vs "
              f"{want[0].tolist()}")
        errs = max_err(got[2], want[2]), max_err(got[3], want[3])
        check(errs[0] <= 1e-4 and errs[1] <= 1e-3,
              f"sync_detect != plain on {label}: max |dcfo|, |dratio| = {errs}")
        check(all(torch.equal(g, w) for g, w in zip(got, glue)),
              f"sync_detect is not bit-identical to dense K1 + glue on {label}")
        return errs[0], errs[1], int(got[1].sum())

    k1d_err, n_valid = 0.0, {}
    for x, k, lo, hi, label in (
            (blocks, MAX_FRAMES, HALO_LEFT, HALO_LEFT + BLOCK, "executor blocks"),
            (torch.from_numpy(xf).to(dev), 8, 0, None, "flagship block")):
        e_cfo, e_ratio, n_valid[label] = detect_check(x, k, mp, lo, hi, label)
        k1d_err = max(k1d_err, e_cfo, e_ratio)
    check(n_valid["executor blocks"] >= CHANNELS * n_frames and n_valid["flagship block"] >= 4,
          f"sync_detect: valid candidates {n_valid}")
    # edges on tile boundaries, more than K in one tile, near the end
    edges = [[991, 1984], [992, 1985], [993, 1983], [1023, 2976], [1024], [1025],
             list(range(2100, 3072, 112)) + [5000], [7000], []]
    for plateau in (1, 2, 3):
        x = torch.from_numpy(burst_rows(7200, edges, plateau, seed=plateau)).to(dev)
        for k, lo, hi in ((4, 0, None), (1, 0, None), (8, 0, None), (4, 992, None),
                          (4, 993, None), (4, 0, 992), (4, 0, 993), (4, 991, 994),
                          (4, 1023, 1026), (4, 2976, 7000), (4, 2977, 7001)):
            label = f"burst rows, min_plateau {plateau}, K {k}, search [{lo}, {hi})"
            e_cfo, e_ratio, _ = detect_check(x, k, plateau, lo, hi, label)
            k1d_err = max(k1d_err, e_cfo, e_ratio)
        starts = k1.sync_detect(x, 4, thr, plateau)[0].cpu().tolist()
        check(all(starts[r][: len(e)] == [v - (plateau - 1) for v in sorted(e)[:4]]
                  for r, e in enumerate(edges)),
              f"sync_detect: burst triggers {starts} not where placed")
    print(f"K1 sync_detect: executor blocks ({n_valid['executor blocks']} valid), flagship "
          f"({n_valid['flagship block']} valid), burst rows at tile boundaries / more than K "
          f"a tile / search bounds, min_plateau 1-3: starts and valid exact, max |dcfo|, "
          f"|dratio| {k1d_err:.3g} (atol 1e-4, 1e-3); bit-identical to dense K1 + glue: ok")

    # -- 4. K2 against its plain version, bit-exact ----------------------
    def llrs(b, steps, kind, seed):
        r = np.random.default_rng(seed)
        if kind == "tied":
            v = r.integers(-2, 3, (b, steps, 2)).astype(np.float32)
        else:
            v = (4 * r.standard_normal((b, steps, 2))).astype(np.float32)
        if kind == "punctured":                 # 3/4-rate erasure pattern
            flat = v.reshape(b, -1)
            keep = np.tile(np.array([1, 1, 1, 0, 0, 1], bool), flat.shape[1] // 6 + 1)
            flat[:, ~keep[: flat.shape[1]]] = 0
        return torch.from_numpy(v).to(dev)

    payload_steps = 16 + 8 * PSDU_LEN + 6
    k2_err = 0
    for steps in (payload_steps, 24):
        for kind in ("random", "punctured", "tied"):
            for terminated in (True, False):
                v = llrs(256, steps, kind, seed=steps)
                got = k2.viterbi_decode(v, terminated)
                want = k2.viterbi_decode_plain(v, terminated)
                k2_err = max(k2_err, (got.int() - want.int()).abs().max().item())
                check(torch.equal(got, want),
                      f"viterbi kernel != plain on 256x{steps} {kind} "
                      f"terminated={terminated}: {(got != want).sum().item()} bits differ")
        print(f"K2 viterbi 256x{steps} random/punctured/tied, terminated and not: bit-exact")
    k2m_err = 0
    for kind in ("random", "punctured", "tied"):
        for terminated in (True, False):
            segs = [llrs(256, payload_steps, kind, seed=7), llrs(256, 24, kind, seed=8)]
            flags = [terminated, not terminated]
            want = k2.viterbi_decode_many_plain(segs, flags)
            got = k2.viterbi_decode_many(segs, flags)
            k2m_err = max([k2m_err] + [(g.int() - w.int()).abs().max().item()
                                       for g, w in zip(got, want)])
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"viterbi_decode_many != plain on 256x{payload_steps} + 256x24 {kind} "
                  f"terminated={flags}")
    print(f"K2 viterbi_decode_many 256x{payload_steps} + 256x24 in one launch, "
          f"random/punctured/tied, terminated and not: bit-exact")

    # -- 5. K3 against its plain version ---------------------------------
    def rand(shape, seed, cplx):
        r = np.random.default_rng(seed)
        v = r.standard_normal(shape)
        if cplx:
            v = v + 1j * r.standard_normal(shape)
        return torch.from_numpy(v.astype(np.complex64 if cplx else np.float32)).to(dev)

    k3_err = 0.0
    for n_taps in (5, 48, 129, 200):
        taps = np.random.default_rng(n_taps).standard_normal(n_taps).astype(np.float32)
        for cplx in (False, True):
            x = rand((2, 300), 7, cplx)
            e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
            check(e <= 2e-4, f"fir kernel != plain: {n_taps} taps, complex={cplx}: {e:.3g}")
            k3_err = max(k3_err, e)
    # rows around the 2048-output tile, taps around the 256-tap chunk
    # (unit energy), more than 65 535 rows
    for n_taps in (1, 65, 256, 257, 1000):
        taps = (np.random.default_rng(n_taps).standard_normal(n_taps)
                / np.sqrt(n_taps)).astype(np.float32)
        for cplx in (False, True):
            for shape in ((3, 2047), (3, 2048), (3, 2049), (3, 4097)):
                x = rand(shape, n_taps, cplx)
                e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
                check(e <= 2e-4, f"fir kernel != plain: {shape} x {n_taps} taps, "
                                 f"complex={cplx}: {e:.3g}")
                k3_err = max(k3_err, e)
    x = rand((70_000, 40), 5, True)
    taps = np.random.default_rng(5).standard_normal(65).astype(np.float32) / 8
    e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
    check(e <= 2e-4, f"fir kernel != plain on (70000, 40): {e:.3g}")
    k3_err = max(k3_err, e)
    iso = torch.zeros(2, 256, device=dev)
    iso[0, 250] = 1.0
    y_iso = k34.fir_filter(iso, np.ones(64, np.float32))
    check(y_iso[1].abs().max().item() == 0.0 and y_iso[0, 250:].min().item() == 1.0,
          "fir kernel: samples leak across rows")
    fir_taps = scipy.signal.firwin(FIR_TAPS, 0.5).astype(np.float32)     # 65-tap low-pass
    fir_x = torch.from_numpy(stream).to(dev)                            # (4, 4 194 304)
    fir_h = torch.from_numpy(fir_taps).to(dev)
    e = max_err(k34.fir_filter(fir_x, fir_h), k34.fir_filter_plain(fir_x, fir_h))
    check(e <= 2e-4, f"fir kernel != plain on {tuple(fir_x.shape)}: {e:.3g}")
    k3_err = max(k3_err, e)
    print(f"K3 fir (2, 300) x 5/48/129/200 taps, (3, 2047/2048/2049/4097) x 1/65/256/257/1000 "
          f"taps, real and complex, (70000, 40) complex, {tuple(fir_x.shape)} complex x "
          f"{FIR_TAPS} taps: max |dy| {k3_err:.3g} (atol 2e-4); rows kept apart: ok")

    # -- 6. K4 against its plain version ---------------------------------
    k4_err = 0.0
    for (l, m) in ((1, 2), (2, 1), (3, 4), (4, 3), (5, 2)):
        taps = ops.design_lowpass(l, m)
        for cplx in (False, True):
            for shape in ((600,), (2, 4, 90)):
                x = rand(shape, l * 10 + m, cplx)
                got = k34.polyphase_resample(x, l, m, taps)
                want = k34.polyphase_resample_plain(x, l, m, taps)
                check(got.shape == want.shape, f"resampler shape {got.shape} != {want.shape}")
                e = max_err(got, want)
                check(e <= 2e-4, f"resampler kernel != plain: {l}/{m} {shape} "
                                 f"complex={cplx}: {e:.3g}")
                k4_err = max(k4_err, e)
    # rows around the 2048-output tile (2730-2732 and 5462 give 2048, 2049
    # and 4097 outputs at 3/4), spans that shrink the tile (1/96), phase
    # rows of other lengths (the generic loop) and of 7000 taps (restaged
    # passes), more than 65 535 rows
    cases = [((3, n), l, m, 12) for n in (2047, 2048, 2049, 4097, 2730, 2731, 2732, 5462)
             for l, m in ((3, 4), (1, 2), (2, 1))]
    cases += [((2, 20_000), 1, 96, 12), ((2, 20_000), 3, 4, 16), ((2, 20_000), 7, 5, 9),
              ((2, 20_000), 1, 2, 7000), ((70_000, 50), 3, 4, 12)]
    for shape, l, m, tpp in cases:
        taps = ops.design_lowpass(l, m, tpp)
        for cplx in (False, True):
            x = rand(shape, l + m + tpp, cplx)
            e = max_err(k34.polyphase_resample(x, l, m, taps),
                        k34.polyphase_resample_plain(x, l, m, taps))
            check(e <= 2e-4, f"resampler kernel != plain: {l}/{m} x {tpp} taps a phase "
                             f"{shape} complex={cplx}: {e:.3g}")
            k4_err = max(k4_err, e)
    # the executor's general front-end input: the 4/3 capture, padded
    ex_34 = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), device=dev, exec_cfg=dataclasses.replace(
        cfg, frontend=FrontendConfig(resample=(3, 4))))
    fe_34 = ex_34.frontend
    np_out = ex_34.padded_out_len(fe_34.out_len(cap_34.shape[1]))
    p_in, n_in_pad, _ = fe_34.padded_geometry(np_out, HALO_LEFT)
    k4_x = torch.zeros(CHANNELS, n_in_pad, dtype=torch.complex64, device=dev)
    k4_x[:, p_in: p_in + cap_34.shape[1]] = torch.from_numpy(cap_34).to(dev)
    k4_taps = ops.design_lowpass(3, 4)
    k4_h = torch.from_numpy(k4_taps).to(dev)
    k4_y = k34.polyphase_resample(k4_x, 3, 4, k4_h)
    e = max_err(k4_y, k34.polyphase_resample_plain(k4_x, 3, 4, k4_h))
    check(e <= 2e-4, f"resampler kernel != plain on {tuple(k4_x.shape)} at 3/4: {e:.3g}")
    k4_err = max(k4_err, e)
    # past the int32 index range: j * M passes 2**31 after 85 900 outputs
    f0, n_tone = 0.01, 1 << 20
    tone = torch.from_numpy(np.exp(2j * np.pi * f0 * np.arange(n_tone))[None].astype(
        np.complex64)).to(dev)
    big_taps = ops.design_lowpass(25001, 25000)
    y_tone = k34.polyphase_resample(tone, 25001, 25000, big_taps)
    e = max_err(y_tone, k34.polyphase_resample_plain(tone, 25001, 25000, big_taps))
    check(e <= 2e-4, f"resampler kernel != plain at 25001/25000: {e:.3g}")
    k4_err = max(k4_err, e)
    j = np.arange(200, y_tone.shape[-1] - 200)
    truth = np.exp(2j * np.pi * f0 * j * (25000 / 25001))
    e_tone = float(np.abs(y_tone[0, 200:-200].cpu().numpy() - truth).max())
    check(j[-1] * 25000 >= 2**31 and e_tone <= 1e-3,
          f"resampler at 25001/25000: tone error {e_tone:.3g} > 1e-3")
    print(f"K4 resample 1/2 2/1 3/4 4/3 5/2 real and complex at (600,) and (2, 4, 90), "
          f"rows around the tile at 3/4 1/2 2/1, 1/96, 12-16-9-7000 taps a phase, "
          f"(70000, 50), "
          f"{tuple(k4_x.shape)} at 3/4, (1, {n_tone}) at 25001/25000: max |dy| {k4_err:.3g} "
          f"(atol 2e-4); tone error past j*M = 2**31: {e_tone:.3g} (<= 1e-3): ok")

    # -- 7. flagship block through sync.receive --------------------------
    plan = tx.tx_plan(MCS, PSDU_LEN)
    reset()
    res, cand = sync.receive(xf, plan, max_frames=8, device=dev)
    flag_launches = counts()
    valid = cand.valid.cpu().numpy()
    psdu = res.psdu.cpu().numpy()
    check(valid.sum() == 4 and np.array_equal(psdu[valid], frames),
          f"flagship: {valid.sum()} valid slots of 8, or the frames differ")
    cres, ccand = sync.receive(xf, plan, max_frames=8, device="cpu")
    check(np.array_equal(ccand.starts.numpy(), cand.starts.cpu().numpy())
          and np.array_equal(ccand.valid.numpy(), valid)
          and np.array_equal(cres.psdu.numpy(), psdu)
          and np.abs(ccand.cfo.numpy() - cand.cfo.cpu().numpy()).max() < 1e-4,
          "flagship: the CUDA path disagrees with the port's CPU path")
    check_path_launches(flag_launches, 1, "flagship")
    print(f"flagship receive: 4/4 frames bit-exact, matches the CPU path; "
          f"launches {json.dumps(flag_launches)}")

    # -- 8. StreamExecutor at the device_step shape ----------------------
    def check_records(records, label):
        for ci in range(CHANNELS):
            got = {tuple(r.psdu) for r in records if r.channel == ci and r.parity_ok}
            missing = [i for i, f in enumerate(payloads[ci]) if tuple(f) not in got]
            check(not missing, f"{label}: channel {ci} frames {missing} not recovered")
        n_ok = sum(r.parity_ok for r in records)
        check(n_ok == CHANNELS * n_frames,
              f"{label}: {n_ok} good records, expected {CHANNELS * n_frames}")
        return n_ok

    reset()
    records = ex.run(stream)
    main_launches = counts()
    check_path_launches(main_launches, n_steps(ex, stream), "executor")
    n_ok = check_records(records, "executor")
    print(f"executor run: {n_ok}/{CHANNELS * n_frames} frames bit-exact; "
          f"launches {json.dumps(main_launches)}")

    ex.stage_resident(stream)
    reps = 5
    step_ms = cuda_ms(lambda: ex.step(0), reps)
    samples = CHANNELS * TIME_BLOCKS * BLOCK
    print(f"executor device_step {CHANNELS}x{TIME_BLOCKS}x{BLOCK} sc16: {step_ms:.3f} ms/step, "
          f"{samples / step_ms / 1e3:.1f} Msamples/s (CUDA events, {reps} steps; {card})")

    # where one step's device time goes (torch.profiler, CUDA activity)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        ex.step(0)
        torch.cuda.synchronize()
        t_wall = (time.perf_counter() - t_wall) * 1e3
    # device activities: kernels and copies; the executor.* ranges also
    # appear on the device timeline (as spans), so they are kept apart
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in dev_events if not e.name.startswith("executor.")]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    spans = {}                  # layer -> [span on the device timeline, busy in it]
    for e in dev_events:
        if e.name.startswith("executor."):
            r = e.time_range
            spans[e.name] = [round(r.elapsed_us() / 1e3, 3), round(sum(
                k.time_range.elapsed_us() for k in kern
                if r.start <= k.time_range.start < r.end) / 1e3, 3)]
    by_name: dict[str, list] = {}
    for e in kern:
        by_name.setdefault(e.name[:60], []).append(e.time_range.elapsed_us() / 1e3)
    print(f"profiled step: {t_wall:.3f} ms wall, {busy:.3f} ms device busy "
          f"({100 * (1 - busy / t_wall):.1f}% idle), {len(kern)} device activities; "
          f"layers [device span, device busy] (ms) {json.dumps(spans)}")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  {sum(ts):8.3f} ms  x{len(ts):<5d} {name}")
    del ex

    # -- 9. the stand-alone entry points ---------------------------------
    reset()
    fir_y = ops.fir_filter(fir_x, fir_taps)
    fir_launches = counts()
    check(fir_launches["fir_filter"] > 0, f"ops.fir_filter: K3 was not launched: {fir_launches}")
    check(bool(torch.isfinite(fir_y).all()) and fir_y.shape == fir_x.shape,
          "ops.fir_filter: output not finite or of the wrong shape")
    print(f"ops.fir_filter {tuple(fir_x.shape)} x {FIR_TAPS} taps; "
          f"launches {json.dumps(fir_launches)}")
    del fir_y
    reset()
    a, p, c = sync.sync_stats(blocks)
    stats_launches = counts()
    check(stats_launches["sync_stats"] == 1 and all(
        bool(torch.isfinite(v).all()) and v.shape == blocks.shape for v in (a, p, c)),
          f"sync.sync_stats: not one dense K1 launch ({stats_launches}), or bad output")
    del a, p, c
    n_slots = CHANNELS * TIME_BLOCKS * MAX_FRAMES
    pay, sig = llrs(n_slots, payload_steps, "random", 1), llrs(n_slots, 24, "random", 2)
    reset()
    vit_bits = viterbi.decode(pay.reshape(n_slots, -1), payload_steps)
    vit_launches = counts()
    check(vit_launches["viterbi_decode"] == 1 and vit_bits.shape == (n_slots, payload_steps),
          f"viterbi.decode: not one one-segment K2 launch ({vit_launches}), or bad output")
    print(f"sync.sync_stats {tuple(blocks.shape)}; launches {json.dumps(stats_launches)}; "
          f"viterbi.decode ({n_slots}, {2 * payload_steps}); launches {json.dumps(vit_launches)}")

    # -- 10. executor with the general front-end (3/4) -------------------
    reset()
    t_run = time.perf_counter()
    records = ex_34.run(cap_34)
    gen_launches = counts()
    t_run = time.perf_counter() - t_run
    check_path_launches(gen_launches, n_steps(ex_34, cap_34), "executor 3/4",
                        also=("polyphase_resample",))
    n_ok = check_records(records, "executor 3/4")
    print(f"executor run, resample=(3, 4), input {cap_34.shape}: {n_ok}/{CHANNELS * n_frames} "
          f"frames bit-exact ({t_run:.2f} s wall); launches {json.dumps(gen_launches)}")
    del ex_34

    # -- 11. executor with decimation + clock trim -----------------------
    ex_ppm = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), device=dev, exec_cfg=dataclasses.replace(
        cfg, frontend=FrontendConfig(resample=(1, 2), ppm=40.0)))
    reset()
    t_run = time.perf_counter()
    records = ex_ppm.run(cap_ppm)
    ppm_launches = counts()
    t_run = time.perf_counter() - t_run
    check_path_launches(ppm_launches, n_steps(ex_ppm, cap_ppm), "executor (1/2, +40 ppm)")
    n_ok = check_records(records, "executor (1/2, +40 ppm)")
    print(f"executor run, resample=(1, 2) ppm=40, input {cap_ppm.shape}: "
          f"{n_ok}/{CHANNELS * n_frames} frames bit-exact ({t_run:.2f} s wall); "
          f"launches {json.dumps(ppm_launches)}")
    del ex_ppm, cap_ppm

    # -- 12. front-end pass rates ----------------------------------------
    frng = np.random.default_rng(5)
    rates = {}
    for label, fe_cfg in (("decim2", FrontendConfig(resample=(1, 2))),
                          ("ppm40", FrontendConfig(ppm=40.0)),
                          ("general3/4", FrontendConfig(resample=(3, 4)))):
        fe = cached_frontend(fe_cfg)
        _, n_pad, aux = fe.padded_geometry(FE_OUT_PAD, 256)
        wire = torch.from_numpy((frng.standard_normal((1, n_pad, 2)) * 0.1).astype(
            np.float32)).to(dev)
        aux = tuple(a.to(dev) for a in aux)
        ms = cuda_ms(lambda: corrected_resident(fe, wire, FE_OUT_PAD, aux), 5)
        rates[label] = {"input_samples": n_pad, "ms": round(ms, 4),
                        "input_msamples_per_s": round(n_pad / ms / 1e3, 1)}
    print(f"front-end pass, {FE_OUT_PAD} padded outputs, f32 wire, 1 channel (CUDA events, "
          f"5 passes; {card}): {json.dumps(rates)}")

    # -- 13. kernel timings at the main paths' shapes --------------------
    rows, n_ext = blocks.shape
    k1_ms = cuda_ms(lambda: k1.sync_stats(blocks), 20)
    k1_plain = cuda_ms(lambda: k1.sync_stats_plain(blocks), 3)
    k1_bound = {"bytes": rows * n_ext * (8 + 16) / HBM_BYTES_PER_S * 1e3,
                "operations": rows * n_ext * K1_OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3}
    # the fused detector as the executor calls it, beside the PR 2 path
    # it replaces (dense K1 and the torch glue: top-k, cats, elementwise)
    det_args = (MAX_FRAMES, thr, mp, HALO_LEFT, HALO_LEFT + BLOCK)

    def dense_and_glue():
        a, _, c = k1.sync_stats(blocks)
        return k1.detect_from_stats(a, c, *det_args)

    det_buf = k1._detect_buffer(rows, n_ext, MAX_FRAMES, dev)
    k1d_ms = cuda_ms(lambda: k1._detect_launch(blocks, *det_args, det_buf), 20)
    k1d_call = cuda_ms(lambda: k1.sync_detect(blocks, *det_args), 20)
    k1d_glue = cuda_ms(dense_and_glue, 10)
    k1d_plain = cuda_ms(lambda: k1.sync_detect_plain(blocks, *det_args), 3)
    k1d_bound = {"bytes": (rows * n_ext * 8 + rows * MAX_FRAMES * (4 + 1 + 8 + 4))
                 / HBM_BYTES_PER_S * 1e3,
                 "operations": rows * n_ext * K1_DETECT_OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3}

    # K2 on the step's payload (pay) and SIGNAL (sig) trellises
    k2_pay, k2_sig = (cuda_ms(lambda: k2.viterbi_decode(v), 20) for v in (pay, sig))
    k2_pay_plain, k2_sig_plain = (cuda_ms(lambda: k2.viterbi_decode_plain(v), 2)
                                  for v in (pay, sig))
    k2_ms, k2_plain = k2_pay + k2_sig, k2_pay_plain + k2_sig_plain
    k2m_ms = cuda_ms(lambda: k2.viterbi_decode_many([pay, sig], [True, True]), 20)
    k2m_plain = cuda_ms(lambda: k2.viterbi_decode_many_plain([pay, sig], [True, True]), 2)
    k2_steps = n_slots * (payload_steps + 24)
    k2_bound = {"bytes": k2_steps * (8 + 1) / HBM_BYTES_PER_S * 1e3,
                "operations": k2_steps * K2_OPS_PER_STEP / FP32_OPS_PER_S * 1e3}
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    k2_floor = payload_steps * (K2_ACS_CYCLES + K2_TRACEBACK_CYCLES) / (sm_mhz * 1e3)
    print(f"K1 on ({rows}, {n_ext}): dense {k1_ms:.4f} ms (bound bytes "
          f"{k1_bound['bytes']:.4f}, operations {k1_bound['operations']:.4f}); fused detector, "
          f"both launches {k1d_ms:.4f} ms, the wrapper's whole call {k1d_call:.4f} ms, against "
          f"dense K1 + torch glue {k1d_glue:.4f} ms (bound bytes {k1d_bound['bytes']:.4f}, "
          f"operations {k1d_bound['operations']:.4f}); K2 one launch for ({n_slots}, "
          f"{payload_steps}) + ({n_slots}, 24) {k2m_ms:.4f} ms, "
          f"two one-segment launches {k2_ms:.4f} ms; chain floor "
          f"({K2_ACS_CYCLES} + {K2_TRACEBACK_CYCLES} cycles a step x {payload_steps} steps at "
          f"{sm_mhz:.0f} MHz) {k2_floor:.4f} ms (CUDA events; {card})")

    # K3 on the 4-channel stream, 65 taps; library: cuDNN conv1d on the
    # re/im rows (laid out outside the timed call) with flipped taps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # numpy taps, as ops.fir_filter's callers pass them; then the same
    # taps as a CUDA tensor
    k3_ms = cuda_ms(lambda: k34.fir_filter(fir_x, fir_taps), 20)
    k3_dev_ms = cuda_ms(lambda: k34.fir_filter(fir_x, fir_h), 20)
    k3_plain = cuda_ms(lambda: k34.fir_filter_plain(fir_x, fir_h), 3)
    re_im = torch.view_as_real(fir_x).permute(0, 2, 1).reshape(-1, 1, n).contiguous()
    w3 = fir_h.flip(0).reshape(1, 1, -1)
    k3_lib = cuda_ms(lambda: torch.nn.functional.conv1d(re_im, w3, padding=FIR_TAPS - 1), 20)
    lib_y = torch.nn.functional.conv1d(re_im, w3, padding=FIR_TAPS - 1)[..., :n]
    k3_lib_err = max_err(torch.view_as_complex(lib_y.reshape(CHANNELS, 2, n).permute(
        0, 2, 1).contiguous()), k34.fir_filter(fir_x, fir_h))
    del re_im, lib_y
    k3_n = fir_x.numel()
    k3_bound = {"bytes": (k3_n * (8 + 8) + FIR_TAPS * 4) / HBM_BYTES_PER_S * 1e3,
                "operations": k3_n * FIR_TAPS * OPS_PER_COMPLEX_TAP / FP32_OPS_PER_S * 1e3}

    # K4 on the general front-end's input; library: conv1d with stride M
    # over the L-fold zero-stuffed re/im rows (stuffed and padded outside
    # the timed call) with flipped taps
    # numpy taps, as the front-end passes them (phase table cached on the card)
    k4_ms = cuda_ms(lambda: k34.polyphase_resample(k4_x, 3, 4, k4_taps), 20)
    k4_plain = cuda_ms(lambda: k34.polyphase_resample_plain(k4_x, 3, 4, k4_h), 3)
    n_out4 = k4_y.shape[-1]
    n_t4 = k4_taps.size
    stuffed = torch.zeros(2 * CHANNELS, 1, n_in_pad * 3, device=dev)
    stuffed[:, 0, ::3] = torch.view_as_real(k4_x).permute(0, 2, 1).reshape(-1, n_in_pad)
    left = n_t4 - 1 - (n_t4 - 1) // 2
    right = max(0, (n_out4 - 1) * 4 + n_t4 - stuffed.shape[-1] - left)
    stuffed = torch.nn.functional.pad(stuffed, (left, right))
    w4 = k4_h.flip(0).reshape(1, 1, -1)
    k4_lib = cuda_ms(lambda: torch.nn.functional.conv1d(stuffed, w4, stride=4), 20)
    lib_y = torch.nn.functional.conv1d(stuffed, w4, stride=4)[..., :n_out4]
    k4_lib_err = max_err(torch.view_as_complex(lib_y.reshape(CHANNELS, 2, n_out4).permute(
        0, 2, 1).contiguous()), k4_y)
    del stuffed, lib_y
    # each term that the direct form sums is counted: every tap index is
    # valid (36 taps = 12 a phase x 3), a sample index only inside the row
    j4 = torch.arange(n_out4, device=dev, dtype=torch.int64) * 4 + (n_t4 - 1) // 2
    base4 = j4 // 3
    terms = sum(int(((base4 - k >= 0) & (base4 - k < n_in_pad)).sum())
                for k in range(-(-n_t4 // 3)))
    k4_bound = {"bytes": (k4_x.numel() * 8 + k4_y.numel() * 8 + n_t4 * 4)
                / HBM_BYTES_PER_S * 1e3,
                "operations": CHANNELS * terms * OPS_PER_COMPLEX_TAP / FP32_OPS_PER_S * 1e3}
    print(f"library yardsticks (conv1d, TF32 off): fir {k3_lib:.4f} ms (max |dy| vs K3 "
          f"{k3_lib_err:.3g}), resample {k4_lib:.4f} ms (max |dy| vs K4 {k4_lib_err:.3g})")

    pkg_src = f"{PKG}/csrc"
    jax_ops = "gnuradio_wifi_imagetransfer_tpu/ops"
    out = []
    for name, src, replaces, launches, err, ms, plain, bound, lib in (
            ("sync_stats", "sync_stats.cu", "pallas_sync.py:104",
             stats_launches["sync_stats"], k1_err, k1_ms, k1_plain, k1_bound, None),
            ("sync_detect", "sync_stats.cu", "pallas_sync.py:104",
             main_launches["sync_detect"], k1d_err, k1d_ms, k1d_plain, k1d_bound, None),
            ("viterbi_decode", "viterbi_acs.cu", "pallas_viterbi.py:125",
             vit_launches["viterbi_decode"], float(k2_err), k2_ms, k2_plain, k2_bound, None),
            ("viterbi_decode_many", "viterbi_acs.cu", "pallas_viterbi.py:125",
             main_launches["viterbi_decode_many"], float(k2m_err), k2m_ms, k2m_plain, k2_bound,
             None),
            ("fir_filter", "fir.cu", "pallas_fir.py:84", fir_launches["fir_filter"],
             k3_err, k3_ms, k3_plain, k3_bound, k3_lib),
            ("polyphase_resample", "fir.cu", "pallas_fir.py:179",
             gen_launches["polyphase_resample"], k4_err, k4_ms, k4_plain, k4_bound, k4_lib)):
        by = max(bound, key=bound.get)
        out.append({"name": name, "route": "cuda", "source": f"{pkg_src}/{src}",
                    "replaces": f"{jax_ops}/{replaces}", "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound[by],
                    "bound_by": by, "library_ms": lib})
    print(f"per executor step: sync_detect on ({rows}, {n_ext}): {k1d_ms:.4f} ms, plain "
          f"{k1d_plain:.3f} ms; viterbi_decode_many on ({n_slots}, {payload_steps}) + "
          f"({n_slots}, 24): {k2m_ms:.4f} ms, plain {k2m_plain:.2f} ms. Off the step: "
          f"sync_stats {k1_ms:.4f} ms, plain {k1_plain:.3f} ms; viterbi_decode "
          f"{k2_pay:.4f} + {k2_sig:.4f} ms, plain {k2_pay_plain:.2f} + {k2_sig_plain:.2f} ms "
          f"(CUDA events; {card})")
    k3_b, k4_b = max(k3_bound.values()), max(k4_bound.values())
    print(f"fir_filter on {tuple(fir_x.shape)} x {FIR_TAPS} taps: {k3_ms:.4f} ms ({k3_b / k3_ms:.0%} "
          f"of its {k3_b:.4f} ms bound; taps as a CUDA tensor {k3_dev_ms:.4f} ms), plain "
          f"{k3_plain:.3f} ms, conv1d {k3_lib:.4f} ms; "
          f"polyphase_resample 3/4 on {tuple(k4_x.shape)} -> {n_out4}: {k4_ms:.4f} ms "
          f"({k4_b / k4_ms:.0%} of its {k4_b:.4f} ms bound), plain {k4_plain:.3f} ms, conv1d "
          f"{k4_lib:.4f} ms (CUDA events; {card})")
    if parent:
        # the parent checkout's K3 and K4 beside this one's, in turns
        for root in (parent, HERE, HERE, parent):
            r = fir_times_of(root)
            f, fd, rs = (min(r[k]) for k in ("fir_ms", "fir_device_taps_ms", "resample_ms"))
            print(f"  {'parent' if root == parent else 'this tree'} ({root}): fir_filter "
                  f"{f:.4f} ms ({k3_b / f:.0%} of bound; taps as a CUDA tensor {fd:.4f} ms), "
                  f"polyphase_resample {rs:.4f} ms ({k4_b / rs:.0%} of bound) (best of 3 x 20, "
                  f"CUDA events; {card})")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "gnuradio_wifi_imagetransfer_tpu"
                    or m.startswith("gnuradio_wifi_imagetransfer_tpu."))
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
