"""Observability for the port: per-stage counters and timers, the
per-frame EVM SNR probe, the radios' headless GUI-sink probes and a
profiler scope (the JAX package's utils/tracing.py).

    Tracer        thread-safe per-stage counters (samples, frames, calls,
                  seconds) with a ``stage()`` timing context manager,
                  which with a prefix is also a profiler range;
    evm_snr_db    batched EVM -> SNR metric of equalized frames, on the
                  symbols' device;
    SnrProbe      EWMA second/fourth-moment SNR estimator matching the
                  reference's probe_mpsk_snr_est_c(alpha=0.05) (numpy);
    ConstellationProbe  ring buffer of recent equalized symbols (the
                  const_sink_c analogue; numpy);
    SpectrumProbe Welch-averaged PSD of recent samples (freq/waterfall
                  sink analogue; numpy);
    profile()     context manager around torch.profiler that writes a
                  Chrome trace.

The port's own card timers, which raise where there is no card (a host
clock is no device time):

    cuda_ms         mean device ms of a run of calls (CUDA events, the
                    host queued behind a device sleep);
    cuda_event_ms   median device ms of calls that each return to the host;
    device_profile  one call under torch.profiler: wall and busy ms, the
                    kernels by name, the ``executor.*`` ranges' spans;
    print_profile   prints a ``device_profile`` result.

``recording`` keeps the arguments of each call made through a kernel
wrapper's module attribute, so that a run's calls can be made again
through the kernel and its plain version (``ops.holds``).

The executors feed their Tracer's stages; the radios (runtime/bridge.py)
feed the three probes, and LoopbackRadio its own ``radio.*`` stages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    samples: int = 0
    frames: int = 0

    def throughput_msps(self) -> float:
        """Msamples/s through this stage (0 when untimed)."""
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0


class _Stage:
    """One ``Tracer.stage`` invocation. A plain class and not a generator's
    context manager: between a batch's device calls the latter costs about
    twice as much, and a radio opens some ten stages a batch."""

    __slots__ = ("tracer", "name", "samples", "frames", "t0", "rng")

    def __init__(self, tracer: "Tracer", name: str, samples: int, frames: int):
        self.tracer, self.name, self.samples, self.frames = tracer, name, samples, frames
        self.rng = None

    def __enter__(self) -> None:
        prefix = self.tracer.prefix
        if prefix is not None and torch.autograd._profiler_enabled():
            self.rng = torch.profiler.record_function(f"{prefix}.{self.name}")
            self.rng.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        self.tracer.add(self.name, dt, self.samples, self.frames)


class Tracer:
    """Thread-safe per-stage counter registry.

    With a ``prefix``, each ``stage(name)`` is also a
    ``torch.profiler.record_function`` range ``<prefix>.<name>`` while a
    profiler records on the calling thread, so the stages sit on the
    profiler's timeline beside the kernels they launch and inside the
    caller's own ranges; with no profiler a stage opens no range."""

    def __init__(self, prefix: str | None = None):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._stages: dict[str, StageStats] = {}

    def _get(self, name: str) -> StageStats:
        if name not in self._stages:
            self._stages[name] = StageStats()
        return self._stages[name]

    def stage(self, name: str, samples: int = 0, frames: int = 0) -> "_Stage":
        """Time a stage invocation (host clock) and attribute samples/frames."""
        return _Stage(self, name, samples, frames)

    def add(self, name: str, seconds: float, samples: int = 0, frames: int = 0,
            calls: int = 1):
        """Attribute a duration measured elsewhere (seconds), with its counts."""
        with self._lock:
            s = self._get(name)
            s.calls += calls
            s.seconds += seconds
            s.samples += samples
            s.frames += frames

    def count(self, name: str, samples: int = 0, frames: int = 0, calls: int = 1):
        """Attribute counts to a stage without timing it."""
        self.add(name, 0.0, samples, frames, calls)

    def report(self) -> dict[str, StageStats]:
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._stages.items()}

    def summary(self) -> str:
        rows = ["stage                 calls      sec     Msamples  frames  Msps"]
        for name, s in sorted(self.report().items()):
            rows.append(
                f"{name:<20} {s.calls:>6} {s.seconds:>8.3f} "
                f"{s.samples / 1e6:>10.3f} {s.frames:>7} "
                f"{s.throughput_msps():>7.1f}")
        return "\n".join(rows)

    def reset(self):
        with self._lock:
            self._stages.clear()


_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def evm_snr_db(eq_symbols: torch.Tensor, mcs: int) -> torch.Tensor:
    """Per-frame SNR estimate from equalized data symbols (..., S, 48):
    P_signal / P_error against the nearest constellation point, in dB,
    reduced over the trailing (symbol, carrier) axes -> (...,) float32."""
    points = device_table(params.constellation, int(params.MCS_N_BPSC[mcs]),
                          device=eq_symbols.device)
    idx = torch.argmin((eq_symbols[..., None] - points).abs() ** 2, dim=-1)
    nearest = points[idx]
    err = ((eq_symbols - nearest).abs() ** 2).mean(dim=(-2, -1))
    sig = (nearest.abs() ** 2).mean(dim=(-2, -1))
    return (10.0 * torch.log10(torch.clamp(sig, min=1e-12)
                               / torch.clamp(err, min=1e-12))).to(torch.float32)


class SnrProbe:
    """Running M2/M4 SNR estimator (probe_mpsk_snr_est_c semantics).

    The GNU Radio probe updates second/fourth moments with EWMA alpha
    (instantiated alpha=0.05, IRS_AP.py:275) and derives SNR via the
    M2M4 estimator. Host-side, numpy."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.m2: float | None = None
        self.m4: float | None = None

    def update(self, symbols: np.ndarray) -> float:
        s = np.asarray(symbols).ravel()
        p2 = float(np.mean(np.abs(s) ** 2))
        p4 = float(np.mean(np.abs(s) ** 4))
        if self.m2 is None:
            self.m2, self.m4 = p2, p4
        else:
            a = self.alpha
            self.m2 = (1 - a) * self.m2 + a * p2
            self.m4 = (1 - a) * self.m4 + a * p4
        return self.snr_db()

    def snr_db(self) -> float:
        if self.m2 is None:
            return float("nan")
        # M2M4 for constant-modulus signal + complex AWGN:
        #   S = sqrt(2*M2^2 - M4), N = M2 - S
        s = np.sqrt(max(2 * self.m2**2 - self.m4, 1e-20))
        n = max(self.m2 - s, 1e-20)
        return float(10.0 * np.log10(s / n))


class ConstellationProbe:
    """Ring buffer of recent equalized data-carrier symbols.

    The analogue of the reference's constellation display chain:
    frame_equalizer's "symbols" message port -> pdu_to_tagged_stream ->
    qtgui.const_sink_c (IRS_AP.py:267,293,312-313). Headless here: the
    probe keeps the latest points for rendering/inspection (the radios
    feed it per decoded frame) and exposes them as (N, 2) re/im float32."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.complex64)
        self._n = 0          # total symbols ever pushed
        self._lock = threading.Lock()

    def push(self, symbols: np.ndarray) -> None:
        s = np.asarray(symbols).ravel().astype(np.complex64)
        if s.size >= self.capacity:
            s = s[-self.capacity:]
        with self._lock:
            pos = self._n % self.capacity
            first = min(self.capacity - pos, s.size)
            self._buf[pos : pos + first] = s[:first]
            if first < s.size:
                self._buf[: s.size - first] = s[first:]
            self._n += s.size

    def points(self, n: int | None = None) -> np.ndarray:
        """Most recent min(n, stored) symbols as (N, 2) float32 re/im."""
        with self._lock:
            stored = min(self._n, self.capacity)
            pos = self._n % self.capacity
            # from the end by explicit starts: [-0:] would be the whole ring
            ring = np.concatenate([self._buf[pos:], self._buf[:pos]])[self.capacity - stored:]
        if n is not None:
            ring = ring[max(ring.size - n, 0):]
        return np.stack([ring.real, ring.imag], axis=-1).astype(np.float32)


class SpectrumProbe:
    """Welch-style averaged power spectrum of recent samples, the headless
    analogue of the reference's qtgui.freq_sink_c / waterfall displays
    (IRS_user.py:174-191). EWMA-averaged periodograms over ``nfft``-sample
    segments, Hann-windowed, fftshifted so bin 0 is -fs/2."""

    def __init__(self, nfft: int = 512, alpha: float = 0.2):
        self.nfft = int(nfft)
        self.alpha = float(alpha)
        self._window = np.hanning(self.nfft).astype(np.float32)
        self._psd: np.ndarray | None = None
        self._lock = threading.Lock()

    def update(self, samples: np.ndarray) -> None:
        x = np.asarray(samples).ravel()
        n_seg = x.size // self.nfft
        if n_seg == 0:
            return
        segs = x[: n_seg * self.nfft].reshape(n_seg, self.nfft) * self._window
        p = np.mean(np.abs(np.fft.fftshift(np.fft.fft(segs, axis=-1),
                                           axes=-1)) ** 2, axis=0)
        with self._lock:
            if self._psd is None:
                self._psd = p
            else:
                self._psd = (1 - self.alpha) * self._psd + self.alpha * p

    def psd_db(self) -> np.ndarray:
        """(nfft,) averaged PSD in dB (NaN-free; -200 dB floor when empty)."""
        with self._lock:
            if self._psd is None:
                return np.full(self.nfft, -200.0, np.float32)
            return (10.0 * np.log10(np.maximum(self._psd, 1e-20))
                    ).astype(np.float32)


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """torch.profiler scope over the block (CPU activity, and CUDA activity
    when a card is present). No-op when logdir is None; otherwise the
    block's trace is written into logdir as a Chrome trace
    (``torch_trace_<pid>_<ms>.json``, readable in chrome://tracing or
    Perfetto). Yields the profiler, or None."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"torch_trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


# Card timers
# ----------------------------------------------------------------------


def _need_card(name: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs a CUDA device (a host clock is no device time)")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up.

    A device sleep of about 20 ms is queued ahead of the timed runs, so
    the host enqueues them while the device waits: where the host keeps
    up, the events time the device work and not the host's dispatch of a
    kernel shorter than its wrapper's call."""
    _need_card("cuda_ms")
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


def cuda_event_ms(fn, n: int) -> float:
    """Median device milliseconds of n calls of fn (CUDA events around
    each; fn returns to the host, so each call is synchronous)."""
    _need_card("cuda_event_ms")
    ms = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    return float(np.median(ms))


def device_profile(fn):
    """Runs fn() once under torch.profiler (CPU and CUDA activity) and
    returns (wall ms, device busy ms, kernels by name {name: [ms, ...]},
    layer spans {range: [span on the device timeline, busy in it, count]}
    of the ``executor.*`` ranges, summed over a range's occurrences,
    number of device activities)."""
    from torch.profiler import ProfilerActivity

    _need_card("device_profile")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_wall = (time.perf_counter() - t_wall) * 1e3
    # device activities: kernels and copies; the executor.* ranges also
    # appear on the device timeline (as spans), so they are kept apart
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in dev_events if not e.name.startswith("executor.")]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    spans: dict[str, list] = {}
    for e in dev_events:
        if e.name.startswith("executor."):
            r = e.time_range
            acc = spans.setdefault(e.name, [0.0, 0.0, 0])
            acc[0] += r.elapsed_us() / 1e3
            acc[1] += sum(k.time_range.elapsed_us() for k in kern
                          if r.start <= k.time_range.start < r.end) / 1e3
            acc[2] += 1
    spans = {k: [round(v[0], 3), round(v[1], 3), v[2]] for k, v in spans.items()}
    by_name: dict[str, list] = {}
    for e in kern:
        by_name.setdefault(e.name[:60], []).append(e.time_range.elapsed_us() / 1e3)
    return t_wall, busy, by_name, spans, len(kern)


def print_profile(label: str, prof) -> None:
    """Prints a ``device_profile`` result: wall, busy and idle share, the
    layers' spans and the 8 kernels that took longest."""
    t_wall, busy, by_name, spans, n_act = prof
    print(f"profiled {label}: {t_wall:.3f} ms wall, {busy:.3f} ms device busy "
          f"({100 * (1 - busy / t_wall):.1f}% idle), {n_act} device activities; "
          f"layers [device span ms, device busy ms, ranges] {json.dumps(spans)}")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  {sum(ts):8.3f} ms  x{len(ts):<5d} {name}")


# Kernel call recording
# ----------------------------------------------------------------------


class _Recorded:
    """A kernel wrapper that keeps the arguments of each call (of the first
    ``keep`` calls, when given). Its ``launches`` is the wrapper's own,
    which the wrapper increments through its module attribute, that is
    through this object."""

    def __init__(self, fn, log: list, keep: int | None = None):
        self.fn, self.log, self.keep = fn, log, keep

    def wants(self) -> bool:
        return self.keep is None or len(self.log) < self.keep

    def __call__(self, *args, **kw):
        # a call inside a CUDA graph's capture launches nothing: its
        # graph's replays hand their inputs over (``replayed``)
        if self.wants() and not build.capturing():
            self.log.append((args, kw))
        return self.fn(*args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def recording(*targets, keep: int | None = None):
    """Within the block, each (module, name) of targets keeps the
    arguments of every call made through that module attribute (of its
    first ``keep`` calls, when given), from any thread, and runs as before
    (its launch count included). Yields {name: [(args, kwargs), ...]}.
    Callers that are to be recorded reach the kernel through its module
    (``viterbi_acs.viterbi_decode_many``), not through a name bound when
    they were imported. A CUDA graph's replay of a kernel call counts and
    records it too (``replayed``)."""
    calls = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        setattr(mod, name, _Recorded(fn, calls[name], keep))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _cloned(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (list, tuple)):
        return type(v)(_cloned(x) for x in v)
    return v


def replayed(wrapper, args: tuple) -> None:
    """A CUDA graph replayed a kernel call that its capture logged
    (``ops.build.count_launch``): adds one to the wrapper's launches and
    hands the call's inputs to each active ``recording`` of the wrapper.
    ``args`` are the graph's own tensors, which hold this replay's inputs
    once it has run, so they are cloned (on the current stream, after the
    replay)."""
    while isinstance(wrapper, _Recorded):
        wrapper = wrapper.fn
    current = getattr(sys.modules[wrapper.__module__], wrapper.__name__)
    current.launches += 1
    inputs = None
    rec = current
    while isinstance(rec, _Recorded):
        if rec.wants():
            inputs = _cloned(args) if inputs is None else inputs
            rec.log.append((inputs, {}))
        rec = rec.fn
