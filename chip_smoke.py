#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Drives the port's RX main path through the entry points a user calls and
holds each hand-written kernel against its plain PyTorch version:

  1. builds the kernels from ``gnuradio_wifi_imagetransfer_tpu_torch/csrc``
     with nvcc (sm_90a) and prints the build seconds;
  2. prints the card's name and power limit (nvidia-smi);
  3. checks the sync-statistics kernel (K1) against its plain version on
     the executor's real blocks: one 263 840-sample row and the 64-row
     batch (atol 2e-4 on a and p, 1e-3 on c where p > 1e-3);
  4. checks the Viterbi kernel (K2) bit-exact against its plain version on
     256 x 422 and 256 x 24 LLRs that are random, punctured and tied;
  5. runs the flagship block: 4 frames (MCS 2, 50-byte PSDUs) made by the
     port's TX in a 32 768-sample block with seeded noise, through
     ``sync.receive`` with 8 slots on CUDA; all 4 frames must come back
     bit-exact and agree with the port's CPU path;
  6. runs the local ``StreamExecutor`` at the bench's device_step shape
     (4 channels x 16 blocks x 262 144 samples, sc16 wire, 4 slots, 3
     frames per block per channel); all 192 frames must come back
     bit-exact; prints the step rate timed with CUDA events;
  7. prints one JSON line of kernel timings, bounds and launch counts.

Launch counts are set to 0 just before each main-path run (5 and 6) and
read just after; launches made to compare or time a kernel do not count.
The last line of stdout is {"ok": true, "device": {...}}. Any failure
exits non-zero. Without CUDA, or without the port package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

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

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per sample of the sync statistics: m (6), |x|^2 (3),
# 48-term complex window (94), 64-term window (63), |a| / p (5)
K1_OPS_PER_SAMPLE = 171
# per frame and trellis step of the Viterbi ACS: 64 states x 2 edges x
# (2 mul + 2 add) + 64 compare/select + 63 max + 64 subtract
K2_OPS_PER_STEP = 64 * 2 * 4 + 64 + 63 + 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_stream(tx, n: int, positions, n_frames: int, rng, device):
    """One channel: n_frames port-TX bursts at positions in seeded noise."""
    frames = rng.integers(0, 256, (n_frames, PSDU_LEN), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=device).cpu().numpy()
    x = np.zeros(n, np.complex64)
    for pos, b in zip(positions, bursts):
        x[pos: pos + b.size] += 0.5 * b
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x.astype(np.complex64), frames


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        port = __import__(PKG)
    except ImportError as e:
        fail(f"the port package {PKG} is not beside this script ({e})")
    check(os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(HERE, PKG),
          f"{PKG} was imported from {port.__file__}, not from this checkout")

    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx

    dev = torch.device("cuda")
    kernels = [k1.sync_stats, k2.viterbi_decode]

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

    # -- 3. K1 against its plain version ---------------------------------
    k1_err = 0.0
    for x in (blocks[:1], blocks):
        a, p, c = k1.sync_stats(x)
        pa, pp, pc = k1.sync_stats_plain(x)
        torch.cuda.synchronize()
        mask = pp > 1e-3
        errs = [(a - pa).abs().max().item(), (p - pp).abs().max().item(),
                (c - pc).abs()[mask].max().item()]
        check(errs[0] <= 2e-4 and errs[1] <= 2e-4 and errs[2] <= 1e-3,
              f"sync_stats kernel disagrees with its plain version on "
              f"{tuple(x.shape)}: max |da|, |dp|, |dc| = {errs}")
        k1_err = max(k1_err, errs[0], errs[1])
        print(f"K1 sync_stats {tuple(x.shape)}: max |da| {errs[0]:.3g}, |dp| {errs[1]:.3g}, "
              f"|dc| {errs[2]:.3g} (atol 2e-4, 2e-4, 1e-3): ok")

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

    # -- 5. flagship block through sync.receive --------------------------
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
    plan = tx.tx_plan(MCS, PSDU_LEN)
    for k in kernels:
        k.launches = 0
    res, cand = sync.receive(xf, plan, max_frames=8, device=dev)
    torch.cuda.synchronize()
    flag_launches = {k.__name__: k.launches for k in kernels}
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
    check(all(v > 0 for v in flag_launches.values()),
          f"flagship: a kernel was not launched: {flag_launches}")
    print(f"flagship receive: 4/4 frames bit-exact, matches the CPU path; "
          f"launches {json.dumps(flag_launches)}")

    # -- 6. StreamExecutor at the device_step shape ----------------------
    for k in kernels:
        k.launches = 0
    records = ex.run(stream)
    torch.cuda.synchronize()
    main_launches = {k.__name__: k.launches for k in kernels}
    check(all(v > 0 for v in main_launches.values()),
          f"executor: a kernel was not launched: {main_launches}")
    for ci in range(CHANNELS):
        got = {tuple(r.psdu) for r in records if r.channel == ci and r.parity_ok}
        missing = [i for i, f in enumerate(payloads[ci]) if tuple(f) not in got]
        check(not missing, f"executor: channel {ci} frames {missing} not recovered")
    n_ok = sum(r.parity_ok for r in records)
    check(n_ok == CHANNELS * n_frames, f"executor: {n_ok} good records, "
          f"expected {CHANNELS * n_frames}")
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

    # -- 7. kernel timings at the main path's shapes ---------------------
    rows, n_ext = blocks.shape
    k1_ms = cuda_ms(lambda: k1.sync_stats(blocks), 20)
    k1_plain = cuda_ms(lambda: k1.sync_stats_plain(blocks), 3)
    k1_bytes = rows * n_ext * (8 + 16)
    k1_ops = rows * n_ext * K1_OPS_PER_SAMPLE
    k1_bound = {"bytes": k1_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": k1_ops / FP32_OPS_PER_S * 1e3}

    n_slots = CHANNELS * TIME_BLOCKS * MAX_FRAMES
    pay, sig = llrs(n_slots, payload_steps, "random", 1), llrs(n_slots, 24, "random", 2)
    k2_pay, k2_sig = (cuda_ms(lambda: k2.viterbi_decode(v), 20) for v in (pay, sig))
    k2_pay_plain, k2_sig_plain = (cuda_ms(lambda: k2.viterbi_decode_plain(v), 2)
                                  for v in (pay, sig))
    k2_ms, k2_plain = k2_pay + k2_sig, k2_pay_plain + k2_sig_plain
    k2_steps = n_slots * (payload_steps + 24)
    k2_bound = {"bytes": k2_steps * (8 + 1) / HBM_BYTES_PER_S * 1e3,
                "operations": k2_steps * K2_OPS_PER_STEP / FP32_OPS_PER_S * 1e3}
    pkg_src = f"{PKG}/csrc"
    out = []
    for name, src, replaces, ms, plain, bound in (
            ("sync_stats", f"{pkg_src}/sync_stats.cu",
             "gnuradio_wifi_imagetransfer_tpu/ops/pallas_sync.py:104", k1_ms, k1_plain,
             k1_bound),
            ("viterbi_decode", f"{pkg_src}/viterbi_acs.cu",
             "gnuradio_wifi_imagetransfer_tpu/ops/pallas_viterbi.py:125", k2_ms, k2_plain,
             k2_bound)):
        by = max(bound, key=bound.get)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": main_launches[name],
                    "max_abs_err": k1_err if name == "sync_stats" else float(k2_err),
                    "ms": ms, "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
                    "library_ms": None})
    print(f"per executor step: sync_stats on ({rows}, {n_ext}): {k1_ms:.4f} ms, plain "
          f"{k1_plain:.3f} ms; viterbi_decode on ({n_slots}, {payload_steps}): "
          f"{k2_pay:.4f} ms, plain {k2_pay_plain:.2f} ms, and on ({n_slots}, 24): "
          f"{k2_sig:.4f} ms, plain {k2_sig_plain:.2f} ms (CUDA events; {card})")

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
