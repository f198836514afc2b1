#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port's streaming 802.11a RX on one NVIDIA GPU.

    python3 bench_torch.py [--phases=device_small,device,...]
    python3 bench_torch.py --device cpu --tiny        # rehearsal on the CPU

The port's twin of bench.py: the same streams, the same phases and the
same result contract, measured through the port's executors on the card
(the RX chain reaches the hand-written kernels K1, ``sync_detect``, and
K2, ``viterbi_decode`` / ``viterbi_decode_many``).

Streams: bench.py's, made by the port's TX on the CPU from
``np.random.default_rng(0)`` in bench.py's order: the primary stream (4
channels x 16 x 262 144 samples, 3 frames of 50 bytes at MCS 2 a block and
channel, 192 in all), a dense stream a MCS (4 x 262 144 samples, frames
back to back, at most 128 a block) and the mixed stream, which rotates
through the 8 rates. They are test data, cached in
``$TMPDIR/gwt_bench_torch_streams_v1.npz``; the RX chain is what is timed.

Phases, each timed in at least REPS repetitions (median and spread,
(max - min) / median) with the launches of the port's kernels:

  device_small  ``StreamExecutor`` (sc16) at 1 x 4 x 65 536: an early number.
  device        the PRIMARY: ``StreamExecutor`` (sc16) at 4 x 16 x 262 144.
                ``run`` must return all 192 frames bit-exact; then, on the
                resident stream, STEP_K steps between a host clock and
                ``torch.cuda.synchronize()``: what the executor pays for a
                step, host dispatch included. This is NOT bench.py's
                on-chip marginal rate: the port's step is host-bound (it
                dispatches a few hundred eager torch ops), so beside the
                rate the detail keeps the step's CUDA-event time and a
                profiled step's device-busy ms and idle share.
  pipeline, pipeline8   a warm ``StreamExecutor.run`` over the primary
                stream on the sc16 and sc8 wire (host layout, copy, steps,
                collection), with the Tracer's stages; every embedded frame
                must come back bit-exact.
  adaptive:<mcs>, adaptive:mix   ``AdaptiveStreamExecutor`` (sc8, 4 x
                262 144, 128 slots a block) on each dense stream and the
                mixed one, in turns: frames/s, every frame back at its rate.
  sweep         the device step on one channel of the primary stream.
  latency:<c>x<t>x<block>   one synchronised step at small, live-radio
                shapes: ms a step, Msamples/s, and the real-time budget of
                that many samples at 20 Msamples/s.
  ingest        host-to-device MB/s of f32, sc16 and sc8 arrays, pageable
                and pinned, as the marginal between 8 M and 32 M elements.
  frontend      the resident front-end pass (``cached_frontend`` ->
                ``correct_padded``) for decim2 and ppm40 at 2**22 corrected
                samples, CUDA events.

Result: the orchestrator (this process; it imports neither torch nor the
port) runs the phases in a worker subprocess (``--worker``), which prints
one ``@PHASE {json}`` line a finished phase, and reprints the whole result
line after every phase, so the LAST line of stdout is always the result:
{"metric": "rx_chain_throughput_per_card", "value": device step
Msamples/s (device_small's if the primary did not land), "unit":
"Msamples/s", "vs_baseline": value / 80, "detail": {...}}. 80 Msamples/s
is the primary stream's 4 channels in real time at 802.11a's 20
Msamples/s, a figure of the radio that belongs to no chip. The budget is
GWT_BENCH_BUDGET_S seconds (default 480); a phase that does not fit is
listed under detail.skipped. A phase whose frames do not all come back
bit-exact, or that raises, is listed under detail.failed and the run exits
non-zero (its last line still printed).

The worker asks for "cuda" and raises without a card; there is no
fallback. ``--device cpu --tiny`` must be asked for: it runs every phase at
tiny shapes on the CPU through the plain kernels, checks every frame, and
prints frame counts and sizes but no time or rate ("value": null).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

MCS = 2
PSDU_LEN = 50
MAX_FRAMES = 4                  # slots a block of the fixed-plan executor
ADAPTIVE_ORDER = (2, 7, 0, 1, 3, 4, 5, 6)
REPS = 3                        # repetitions of each timed measure, in turns
REALTIME_MSPS = 20.0            # 802.11a's sample rate
BASELINE_MSPS = 4 * REALTIME_MSPS
STREAMS_VERSION = "v1"          # bump when the streams' recipe changes
WIRE_BYTES = {"f32": 8, "sc16": 4, "sc8": 2}      # wire bytes a complex sample


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The bench's shapes: bench.py's (FULL), or a rehearsal's (TINY)."""

    block: int
    channels: int
    time_blocks: int
    frames_per_block: int
    dense_blocks: int
    dense_max_frames: int
    small: tuple            # device_small (channels, time shards, block)
    latency: tuple          # ((channels, time shards, block), ...)
    fe_out: int             # front-end corrected samples
    ingest: tuple           # elements of the small and the big transfer
    step_k: int             # steps a timed repetition


FULL = Geometry(block=1 << 18, channels=4, time_blocks=16, frames_per_block=3,
                dense_blocks=4, dense_max_frames=128, small=(1, 4, 1 << 16),
                latency=((1, 1, 1 << 14), (1, 2, 1 << 15), (1, 4, 1 << 16), (2, 8, 1 << 17)),
                fe_out=1 << 22, ingest=(1 << 23, 1 << 25), step_k=10)
TINY = Geometry(block=1 << 13, channels=2, time_blocks=2, frames_per_block=1,
                dense_blocks=1, dense_max_frames=4, small=(1, 2, 1 << 12),
                latency=((1, 1, 1 << 12), (2, 2, 1 << 13)),
                fe_out=1 << 14, ingest=(1 << 12, 1 << 14), step_k=2)

# seconds a phase may take on the card, for the budget gate (first and
# each further adaptive stream)
EST_S = {"device_small": 15, "device": 40, "pipeline": 20, "pipeline8": 20,
         "adaptive": 15, "adaptive_stream": 5, "sweep": 20, "latency": 25, "ingest": 25,
         "frontend": 20}


def phase_ids(g: Geometry) -> tuple[str, ...]:
    return ("device_small", "device", "pipeline", "pipeline8",
            *(f"adaptive:{m}" for m in ADAPTIVE_ORDER), "adaptive:mix", "sweep",
            *(f"latency:{c}x{t}x{b}" for c, t, b in g.latency), "ingest", "frontend")


def stream_cache(tiny: bool) -> str:
    return os.path.join(tempfile.gettempdir(), f"gwt_bench_torch_streams_{STREAMS_VERSION}"
                                               f"{'_tiny' if tiny else ''}.npz")


def _progress(msg: str) -> None:
    sys.stderr.write(f"bench_torch[{time.strftime('%H:%M:%S')}] {msg}\n")
    sys.stderr.flush()


def stats(runs) -> dict:
    """Median and spread ((max - min) / median) of repetitions."""
    runs = [float(v) for v in runs]
    med = float(np.median(runs))
    return {"median": med, "spread": (max(runs) - min(runs)) / med if med else None,
            "runs": runs}


# ======================================================================
# streams (bench.py's _GEN_SNIPPET through the port's TX)
# ======================================================================

def primary_positions(g: Geometry, burst_len: int) -> list[int]:
    n = g.time_blocks * g.block
    n_frames = g.frames_per_block * g.time_blocks
    gap = n // n_frames
    return [min(150 + i * gap, n - burst_len - 1) for i in range(n_frames)]


def make_streams(g: Geometry) -> dict[str, np.ndarray]:
    """bench.py's streams, made by the port's TX on the CPU with the same
    draws from ``default_rng(0)`` in the same order."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    def bursts(frames, mcs, seeds=1):
        return tx.transmit(frames, mcs, scrambler_seed=torch.as_tensor(seeds),
                           device="cpu").numpy()

    def noise(rng, n):
        return 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    rng = np.random.default_rng(0)
    out = {}
    n = g.time_blocks * g.block
    n_frames = g.frames_per_block * g.time_blocks
    streams, payloads = [], []
    for _ in range(g.channels):
        frames = rng.integers(0, 256, (n_frames, PSDU_LEN), dtype=np.uint8)
        b = bursts(frames, MCS)
        x = np.zeros(n, np.complex64)
        for pos, burst in zip(primary_positions(g, b.shape[1]), b):
            x[pos: pos + burst.size] += 0.5 * burst
        x += noise(rng, n)
        streams.append(x.astype(np.complex64))
        payloads.append(frames)
    out["primary"] = np.stack(streams)
    out["primary_payloads"] = np.stack(payloads)

    n = g.dense_blocks * g.block
    for mcs in range(8):
        burst_len = tx.tx_plan(mcs, PSDU_LEN).n_samples
        spacing = max(burst_len + 500, g.block // g.dense_max_frames + 1)
        positions = list(range(300, n - burst_len - 800, spacing))
        frames = rng.integers(0, 256, (len(positions), PSDU_LEN), dtype=np.uint8)
        x = np.zeros(n, np.complex64)
        for pos, burst in zip(positions, bursts(frames, mcs, np.arange(len(positions)) % 127 + 1)):
            x[pos: pos + burst.size] += 0.5 * burst
        x += noise(rng, n)
        out[f"dense{mcs}"] = x.astype(np.complex64)
        out[f"dense{mcs}_payloads"] = frames

    burst_max = max(tx.tx_plan(m, PSDU_LEN).n_samples for m in range(8))
    spacing = max(burst_max + 500, g.block // g.dense_max_frames + 1)
    positions = np.array(range(300, n - burst_max - 800, spacing))
    mcs_seq = np.arange(len(positions)) % 8
    frames = rng.integers(0, 256, (len(positions), PSDU_LEN), dtype=np.uint8)
    x = np.zeros(n, np.complex64)
    for m in range(8):
        sel = np.flatnonzero(mcs_seq == m)
        if not sel.size:
            continue
        for pos, burst in zip(positions[sel], bursts(frames[sel], m, sel % 127 + 1)):
            x[pos: pos + burst.size] += 0.5 * burst
    x += noise(rng, n)
    out["mixed"] = x.astype(np.complex64)
    out["mixed_payloads"] = frames
    out["mixed_mcs"] = mcs_seq.astype(np.int32)
    return out


def load_streams(g: Geometry, tiny: bool) -> tuple[dict, float | None]:
    """The cached streams, made first if the cache is missing. Returns
    (streams, seconds spent making them or None when cached)."""
    path = stream_cache(tiny)
    if os.path.exists(path):
        return dict(np.load(path)), None
    t0 = time.perf_counter()
    data = make_streams(g)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **data)
    os.replace(tmp, path)
    return data, time.perf_counter() - t0


# ======================================================================
# worker (a subprocess: imports torch and the port)
# ======================================================================

class PhaseFailed(Exception):
    """A phase's frames did not all come back bit-exact, or its path
    skipped a kernel it must launch."""


def _emit(name: str, payload: dict) -> None:
    sys.stdout.write("@PHASE " + json.dumps({"name": name, **payload}) + "\n")
    sys.stdout.flush()


class _Worker:
    def __init__(self, dev, g: Geometry, data: dict):
        import torch

        from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2

        self.torch = torch
        self.dev, self.g, self.data = dev, g, data
        self.card = dev.type == "cuda"
        self.kernels = [k1.sync_detect, k1.sync_stats, k2.viterbi_decode,
                        k2.viterbi_decode_many, k34.fir_filter, k34.polyphase_resample]

    # -- clocks and counters ---------------------------------------------

    def sync(self) -> None:
        if self.card:
            self.torch.cuda.synchronize()

    def host_ms(self, fn, k: int = 1, each: bool = False) -> float:
        """ms a call of fn over k calls between a host clock and a
        synchronize (after every call when ``each``)."""
        self.sync()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
            if each:
                self.sync()
        self.sync()
        return (time.perf_counter() - t0) * 1e3 / k

    def event_ms(self, fn, reps: int) -> float:
        """The port's ``cuda_ms`` on the card (CUDA events, the host queued
        behind a device sleep); the host clock on the CPU."""
        if not self.card:
            return self.host_ms(fn, reps)
        from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import cuda_ms

        return cuda_ms(fn, reps)

    def reset(self) -> None:
        for k in self.kernels:
            k.launches = 0

    def counts(self) -> dict:
        self.sync()
        return {k.__name__: k.launches for k in self.kernels}

    def need_launches(self, launches: dict, names, label: str) -> None:
        """On the card the path must have gone through these kernels (a
        CPU tensor takes the plain versions, which count nothing)."""
        missing = [k for k in names if launches[k] == 0]
        if self.card and missing:
            raise PhaseFailed(f"{label}: {missing} not launched ({launches})")

    # -- the fixed-plan executor -----------------------------------------

    def fixed(self, shape, wire: str = "sc16", tracer=None):
        """A StreamExecutor over the first channels x time shards x block
        samples of the primary stream, and the (channel, PSDU) frames whose
        bursts lie wholly in that cut."""
        from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
        from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
        from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

        c, t, block = shape
        plan = tx.tx_plan(MCS, PSDU_LEN)
        cfg = ExecutorConfig(block_size=block, time_shards=t, channels=c,
                             max_frames_per_block=MAX_FRAMES, wire_format=wire)
        ex = StreamExecutor(plan, exec_cfg=cfg, tracer=tracer, device=self.dev)
        n = t * block
        inside = [i for i, p in enumerate(primary_positions(self.g, plan.n_samples))
                  if p + plan.n_samples <= n]
        want = {(ci, tuple(self.data["primary_payloads"][ci, i]))
                for ci in range(c) for i in inside}
        return ex, self.data["primary"][:c, :n], want

    @staticmethod
    def frames_back(recs, want: set, label: str, adaptive: bool = False) -> int:
        """Every wanted (channel, PSDU), or (rate, PSDU) with ``adaptive``,
        among the good records; returns their count."""
        got = {((r.rate_idx if adaptive else r.channel), tuple(r.psdu))
               for r in recs if r.parity_ok}
        if not want <= got:
            raise PhaseFailed(f"{label}: {len(want & got)} of {len(want)} frames bit-exact"
                              f"{' at their rates' if adaptive else ''}")
        return len(want)

    def checked_run(self, ex, x, want, label: str) -> dict:
        """One run with the launches counted from 0: every wanted frame
        back bit-exact, K1 and K2 launched on the card."""
        self.reset()
        recs = ex.run(x)
        launches = self.counts()
        frames = self.frames_back(recs, want, label)
        self.need_launches(launches, ("sync_detect", "viterbi_decode_many"), label)
        return {"frames": frames, "run_launches": launches}

    def step_phase(self, shape, label: str, each: bool = False, profile: bool = False):
        """The checked run, then steps on the resident stream: REPS
        repetitions of STEP_K steps (synchronised after each with
        ``each``), and the launches of one step."""
        c, t, block = shape
        ex, x, want = self.fixed(shape)
        facts = {"shape": f"{c}x{t}x{block}", "wire": "sc16",
                 **self.checked_run(ex, x, want, label)}
        ex.stage_resident(x)
        for _ in range(2):
            ex.step(0)
        self.reset()
        ex.step(0)
        facts["step_launches"] = self.counts()
        self.need_launches(facts["step_launches"], ("sync_detect", "viterbi_decode_many"), label)
        ms = [self.host_ms(lambda: ex.step(0), self.g.step_k, each) for _ in range(REPS)]
        samples = c * t * block
        measured = {"step_ms": stats(ms), "msps": stats([samples / m / 1e3 for m in ms])}
        if profile and self.card:
            from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import device_profile

            measured["step_ms_cuda_events"] = stats(
                [self.event_ms(lambda: ex.step(0), 5) for _ in range(REPS)])
            wall, busy, _, spans, n_act = device_profile(lambda: ex.step(0))
            # idle share of the timed step: the profiler's own host work
            # stretches the profiled step's wall several times over
            measured["profiled_step"] = {"busy_ms": busy, "wall_ms": wall,
                                         "idle_share": 1 - busy / measured["step_ms"]["median"],
                                         "device_activities": n_act, "layers": spans}
        return facts, measured

    def pipeline(self, wire: str):
        from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import Tracer

        g = self.g
        tracer = Tracer()
        ex, x, want = self.fixed((g.channels, g.time_blocks, g.block), wire, tracer)
        facts = {"shape": f"{g.channels}x{g.time_blocks}x{g.block}", "wire": wire,
                 **self.checked_run(ex, x, want, f"pipeline {wire}")}
        ms = []
        for _ in range(REPS):
            tracer.reset()
            recs = []
            ms.append(self.host_ms(lambda: recs.extend(ex.run(x))))
            self.frames_back(recs, want, f"pipeline {wire}")
        stages = {k: v.seconds * 1e3 for k, v in tracer.report().items()}
        return facts, {"run_ms": stats(ms), "msps": stats([x.size / m / 1e3 for m in ms]),
                       "stages_ms_last_run": stages}

    # -- the SIGNAL-steered executor -------------------------------------

    def adaptive(self, ids: list[str]) -> dict:
        """Each stream checked once, then timed in turns for REPS rounds.
        Returns {id: (facts, measured) or an exception}."""
        from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
        from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveStreamExecutor

        g = self.g
        cfg = ExecutorConfig(block_size=g.block, time_shards=g.dense_blocks,
                             max_frames_per_block=g.dense_max_frames, wire_format="sc8")
        aex = AdaptiveStreamExecutor(exec_cfg=cfg, device=self.dev)
        streams, out = {}, {}
        for pid in ids:
            tag = pid.split(":")[1]
            if tag == "mix":
                x, psdus, rates = (self.data["mixed"], self.data["mixed_payloads"],
                                   self.data["mixed_mcs"])
            else:
                x, psdus = self.data[f"dense{tag}"], self.data[f"dense{tag}_payloads"]
                rates = np.full(len(psdus), int(tag))
            want = {(int(m), tuple(f)) for m, f in zip(rates, psdus)}
            streams[pid] = (x[None], want)

        for pid, (x, want) in list(streams.items()):
            try:
                self.reset()
                recs = aex.run(x)
                launches = self.counts()
                frames = self.frames_back(recs, want, pid, adaptive=True)
                self.need_launches(launches, ("sync_detect", "viterbi_decode",
                                              "viterbi_decode_many"), pid)
                out[pid] = ({"stream": list(x.shape), "wire": "sc8", "frames": frames,
                             "run_launches": launches}, {})
            except Exception as e:              # noqa: BLE001 — this stream's failure
                out[pid] = e
                del streams[pid]
        runs = {pid: [] for pid in streams}
        for _ in range(REPS):
            for pid, (x, want) in list(streams.items()):
                recs = []
                runs[pid].append(self.host_ms(lambda: recs.extend(aex.run(x))))
                try:
                    self.frames_back(recs, want, pid, adaptive=True)
                except PhaseFailed as e:
                    out[pid] = e
                    del streams[pid]
        for pid, (_, want) in streams.items():
            out[pid][1].update(run_ms=stats(runs[pid]),
                               fps=stats([len(want) / m * 1e3 for m in runs[pid]]))
        return out

    # -- latency, ingest, front-end ---------------------------------------

    def latency(self, ids: list[str]) -> dict:
        """Each shape checked, then one synchronised step at a time, the
        shapes in turns."""
        shapes, out = {}, {}
        for pid in ids:
            c, t, b = (int(v) for v in pid.split(":")[1].split("x"))
            try:
                ex, x, want = self.fixed((c, t, b))
                facts = {"samples": c * t * b, **self.checked_run(ex, x, want, pid)}
                ex.stage_resident(x)
                ex.step(0)
                self.reset()
                ex.step(0)
                facts["step_launches"] = self.counts()
                shapes[pid] = ex
                out[pid] = (facts, {})
            except Exception as e:              # noqa: BLE001 — this shape's failure
                out[pid] = e
        ms = {pid: [] for pid in shapes}
        for _ in range(REPS):
            for pid, ex in shapes.items():
                ms[pid].append(self.host_ms(lambda: ex.step(0), self.g.step_k, each=True))
        for pid in shapes:
            n = out[pid][0]["samples"]
            out[pid][1].update(step_ms=stats(ms[pid]),
                               msps=stats([n / m / 1e3 for m in ms[pid]]),
                               realtime_budget_ms_at_20msps=n / (REALTIME_MSPS * 1e3))
        return out

    def ingest(self):
        """Host-to-device copies of random bytes as f32, sc16 and sc8
        arrays of the small and the big element count, pageable and (on
        the card) pinned; MB/s as the marginal between the two sizes."""
        torch = self.torch
        rng = np.random.default_rng(123)
        kinds = ("pageable", "pinned") if self.card else ("pageable",)
        srcs = {}
        for fmt, dtype in (("f32", np.float32), ("sc16", np.int16), ("sc8", np.int8)):
            for size in self.g.ingest:
                a = torch.from_numpy(rng.integers(0, 256, size * np.dtype(dtype).itemsize,
                                                  dtype=np.uint8).view(dtype))
                for kind in kinds:
                    srcs[fmt, kind, size] = a.pin_memory() if kind == "pinned" else a
        small, big = self.g.ingest
        mbps = {(fmt, kind): [] for fmt, kind, _ in srcs}
        copies = {}

        def copy(key):
            copies[key] = srcs[key].to(self.dev, non_blocking=key[1] == "pinned", copy=True)

        for _ in range(REPS):
            for fmt, kind in mbps:
                t = {size: self.host_ms(lambda: copy((fmt, kind, size))) for size in (small, big)}
                d_bytes = (big - small) * srcs[fmt, kind, big].element_size()
                mbps[fmt, kind].append(d_bytes / max(t[big] - t[small], 1e-9) / 1e3)
        for key, got in copies.items():
            if not torch.equal(got.cpu().view(torch.uint8), srcs[key].view(torch.uint8)):
                raise PhaseFailed(f"ingest {key}: the copy differs from its source")
        facts = {"elements": list(self.g.ingest), "formats": sorted({f for f, _ in mbps}),
                 "kinds": list(kinds)}
        measured = {fmt: {kind: stats(mbps[fmt, kind]) for f, kind in mbps if f == fmt}
                    for fmt in facts["formats"]}
        return facts, measured

    def frontend(self):
        torch = self.torch
        from gnuradio_wifi_imagetransfer_tpu_torch.config import FrontendConfig
        from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (
            HALO_LEFT,
            corrected_resident,
        )
        from gnuradio_wifi_imagetransfer_tpu_torch.parallel.frontend import cached_frontend

        n_out = self.g.fe_out
        rng = np.random.default_rng(5)
        passes, facts = {}, {}
        for label, cfg in (("decim2", FrontendConfig(resample=(1, 2))),
                           ("ppm40", FrontendConfig(ppm=40.0))):
            fe = cached_frontend(cfg)
            _, n_in, aux = fe.padded_geometry(n_out, HALO_LEFT)
            wire = torch.from_numpy((rng.standard_normal((1, n_in, 2)) * 0.1).astype(
                np.float32)).to(self.dev)
            aux = tuple(a.to(self.dev) for a in aux)
            self.reset()
            y = corrected_resident(fe, wire, n_out, aux)
            launches = self.counts()
            if y.shape != (1, n_out, 2) or not bool(torch.isfinite(y).all()):
                raise PhaseFailed(f"frontend {label}: output {tuple(y.shape)} not finite or "
                                  f"not (1, {n_out}, 2)")
            passes[label] = lambda fe=fe, wire=wire, aux=aux: corrected_resident(
                fe, wire, n_out, aux)
            facts[label] = {"input_samples": int(n_in), "output_samples": n_out,
                            "launches": launches}
        ms = {label: [] for label in passes}
        for _ in range(REPS):
            for label, fn in passes.items():
                ms[label].append(self.event_ms(fn, 5))
        measured = {label: {"ms": stats(v),
                            "out_msps": stats([n_out / m / 1e3 for m in v]),
                            "in_msps": stats([facts[label]["input_samples"] / m / 1e3
                                              for m in v])}
                    for label, v in ms.items()}
        return facts, measured


def _card_info(dev) -> dict:
    import torch

    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 0}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.splitlines()[0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": power, "count": torch.cuda.device_count()}


def _worker_main(args) -> int:
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

    torch.set_num_threads(2)
    dev = resolve(args.device)               # raises without a card: no fallback
    g = TINY if args.tiny else FULL
    if dev.type == "cuda":
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import build

        build.library()                     # nvcc here, not inside a timed phase
    _emit("card", {"device": _card_info(dev)})
    data, made_s = load_streams(g, args.tiny)
    _emit("streams", {"path": stream_cache(args.tiny), "made_s": made_s})
    _progress(f"worker: streams ready ({'cached' if made_s is None else f'{made_s:.1f} s'})")
    w = _Worker(dev, g, data)
    wanted = [p for p in phase_ids(g) if p in args.phases]
    failed = False

    def fits(est: float) -> bool:
        return time.time() + est < args.deadline

    def report(pid: str, result) -> None:
        nonlocal failed
        if isinstance(result, Exception):
            failed = True
            _progress(f"worker: {pid} FAILED: {result!r}")
            _emit(pid, {"ok": False, "error": repr(result)[:2000]})
            return
        facts, measured = result
        _emit(pid, {"ok": True, **facts, **(measured if w.card else {})})
        _progress(f"worker: {pid} done")

    def run(ids: list[str], fn) -> None:
        """fn(ids) -> {id: (facts, measured) or an exception}; an exception
        out of fn fails every id."""
        try:
            results = fn(ids) if ids else {}
        except Exception as e:                  # noqa: BLE001 — reported as failed phases
            traceback.print_exc()
            results = {p: e for p in ids}
        for p in ids:
            report(p, results[p])

    def skip(ids: list[str], why: str) -> None:
        for p in ids:
            _emit(p, {"skipped": why})

    single = {"device_small": lambda: w.step_phase(g.small, "device_small"),
              "device": lambda: w.step_phase((g.channels, g.time_blocks, g.block), "device",
                                             profile=True),
              "pipeline": lambda: w.pipeline("sc16"),
              "pipeline8": lambda: w.pipeline("sc8"),
              "sweep": lambda: w.step_phase((1, g.time_blocks, g.block), "sweep"),
              "ingest": w.ingest, "frontend": w.frontend}
    adaptive = [p for p in wanted if p.startswith("adaptive:")]
    latency = [p for p in wanted if p.startswith("latency:")]
    for pid in wanted:
        if pid in single:
            if fits(EST_S[pid]):
                run([pid], lambda ids: {ids[0]: single[ids[0]]()})
            else:
                skip([pid], f"budget: {EST_S[pid]} s did not fit")
        elif pid in adaptive[:1]:
            # as many streams as fit, in ADAPTIVE_ORDER, the mixed one last
            n = len(adaptive)
            while n and not fits(EST_S["adaptive"] + n * EST_S["adaptive_stream"]):
                n -= 1
            skip(adaptive[n:], "budget: the adaptive streams before it took the time")
            run(adaptive[:n], w.adaptive)
        elif pid in latency[:1]:
            if fits(EST_S["latency"]):
                run(latency, w.latency)
            else:
                skip(latency, f"budget: {EST_S['latency']} s did not fit")
    return 1 if failed else 0


# ======================================================================
# orchestrator (imports neither torch nor the port; owns the budget)
# ======================================================================

class _Result:
    """The cumulative result, reprinted after every phase so that the last
    line of stdout is always the whole of it."""

    def __init__(self, rehearsal: bool = False):
        self.rehearsal = rehearsal
        self.device: dict | None = None
        self.streams: dict | None = None
        self.phases: dict[str, dict] = {}
        self.skipped: dict[str, str] = {}
        self.failed: dict[str, str] = {}
        self.notes: list[str] = []

    def absorb(self, p: dict) -> str | None:
        """Record one @PHASE payload; returns the phase id it finished."""
        p = dict(p)
        name = p.pop("name")
        if name == "card":
            self.device = p["device"]
            return None
        if name == "streams":
            self.streams = p
            return None
        if "skipped" in p:
            self.skipped[name] = p["skipped"]
        elif not p.pop("ok"):
            self.failed[name] = p["error"]
        else:
            self.phases[name] = p
        return name

    def value(self) -> float | None:
        if self.rehearsal:
            return None
        for pid in ("device", "device_small"):
            if "msps" in self.phases.get(pid, {}):
                return self.phases[pid]["msps"]["median"]
        return 0.0

    def _host_model(self) -> dict | None:
        """End-to-end rate if the stream came from the host: min(device
        step rate, ingest MB/s / wire bytes a sample)."""
        ingest, rate = self.phases.get("ingest"), self.value()
        if not ingest or not rate:
            return None
        return {f"{fmt}_{kind}_msps": min(rate, v["median"] / WIRE_BYTES[fmt])
                for fmt in WIRE_BYTES for kind, v in ingest.get(fmt, {}).items()}

    def line(self) -> dict:
        value = self.value()
        return {
            "metric": "rx_chain_throughput_per_card",
            "value": value,
            "unit": "Msamples/s",
            "vs_baseline": None if value is None else value / BASELINE_MSPS,
            "detail": {
                "device": self.device,
                "rehearsal": ("CPU, tiny shapes, plain kernels: frame counts and sizes, "
                              "no times or rates") if self.rehearsal else None,
                "phases": self.phases,
                "skipped": self.skipped,
                "failed": self.failed,
                "host_model": self._host_model(),
                "streams": self.streams,
                "notes": self.notes,
                "note": "value = the port's StreamExecutor step at 4 x 16 x 262 144 sc16, "
                        "steps on the resident stream between a host clock and "
                        "torch.cuda.synchronize (host dispatch included; the step is "
                        "host-bound); vs_baseline = value / 80 Msamples/s, the 4 channels "
                        "in real time at 20 Msamples/s. Every embedded frame is checked "
                        "bit-exact; frames/s = AdaptiveStreamExecutor on dense 50-byte "
                        "streams, each frame at its rate.",
            },
        }

    def print_line(self) -> None:
        print(json.dumps(self.line()))
        sys.stdout.flush()


def _script() -> str:
    """The program to start as the worker: the running script, so that a
    wrapper that patches the port before calling ``main`` patches the
    worker too."""
    main_file = getattr(sys.modules["__main__"], "__file__", None)
    return os.path.abspath(main_file or __file__)


def _run_worker(args, res: _Result, deadline: float) -> int | None:
    """Runs the worker over args.phases until it ends or the deadline
    passes. Returns its exit code, or None when it was killed at the
    deadline."""
    cmd = [sys.executable, _script(), "--worker", f"--deadline={deadline - 5.0:.1f}",
           "--phases=" + ",".join(args.phases), "--device", args.device]
    if args.tiny:
        cmd.append("--tiny")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines: queue.Queue = queue.Queue()
    err_tail: collections.deque = collections.deque(maxlen=12)

    def pump():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)

    def pump_err():
        for ln in proc.stderr:
            sys.stderr.write(ln)
            sys.stderr.flush()
            if ln.strip() and not ln.startswith("bench_torch["):
                err_tail.append(ln.rstrip()[:240])

    threading.Thread(target=pump, daemon=True).start()
    err = threading.Thread(target=pump_err, daemon=True)
    err.start()
    try:
        while True:
            try:
                ln = lines.get(timeout=max(deadline - time.time(), 0.0))
            except queue.Empty:
                _progress("killing the worker: budget exhausted")
                proc.kill()
                proc.wait()
                return None
            if ln is None:
                break
            if ln.startswith("@PHASE ") and res.absorb(json.loads(ln[len("@PHASE "):])):
                res.print_line()
        proc.wait()
        err.join(timeout=5.0)
        if proc.returncode != 0 and err_tail:
            res.notes.append("worker stderr tail: " + " | ".join(list(err_tail)[-4:]))
        return proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _parse(argv):
    ap = argparse.ArgumentParser(description="Benchmark of the port's RX chain on one GPU.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="tiny shapes (with --device cpu: the CPU rehearsal)")
    ap.add_argument("--phases", help="comma-separated phase ids (default: all)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--deadline", type=float, default=float("inf"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if (args.device == "cpu") != args.tiny:
        ap.error("--device cpu and --tiny go together: the CPU runs only the rehearsal")
    ids = phase_ids(TINY if args.tiny else FULL)
    args.phases = ids if args.phases is None else tuple(args.phases.split(","))
    unknown = [p for p in args.phases if p not in ids]
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {','.join(ids)}")
    return args


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.worker:
        return _worker_main(args)
    t0 = time.time()
    budget = float(os.environ.get("GWT_BENCH_BUDGET_S", "480"))
    deadline = t0 + budget - 10.0               # margin for the last prints
    res = _Result(rehearsal=args.tiny)
    rc = _run_worker(args, res, deadline)
    for pid in args.phases:
        if pid not in res.phases and pid not in res.skipped and pid not in res.failed:
            if rc is None:
                res.skipped[pid] = "budget: the worker was stopped at the deadline"
            else:
                res.failed[pid] = f"not run: the worker exited with code {rc}"
    if rc not in (0, None):
        res.notes.append(f"worker exit code {rc}")
    res.notes.append(f"wall {time.time() - t0:.1f} s of a {budget:.0f} s budget")
    res.print_line()
    no_value = not args.tiny and not res.value()
    return 1 if res.failed or rc not in (0, None) or no_value else 0


if __name__ == "__main__":
    sys.exit(main())
