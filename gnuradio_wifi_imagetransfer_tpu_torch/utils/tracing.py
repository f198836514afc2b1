"""Observability for the port: per-stage counters and timers, the
per-frame EVM SNR probe, the radios' headless GUI-sink probes and a
profiler scope (the JAX package's utils/tracing.py).

    Tracer        thread-safe per-stage counters (samples, frames, calls,
                  seconds) with a ``stage()`` timing context manager;
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

The executors feed their Tracer's stages; the radios (runtime/bridge.py)
feed the three probes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    samples: int = 0
    frames: int = 0

    def throughput_msps(self) -> float:
        """Msamples/s through this stage (0 when untimed)."""
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0


class Tracer:
    """Thread-safe per-stage counter registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: dict[str, StageStats] = {}

    def _get(self, name: str) -> StageStats:
        if name not in self._stages:
            self._stages[name] = StageStats()
        return self._stages[name]

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0, frames: int = 0):
        """Time a stage invocation (host clock) and attribute samples/frames."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._get(name)
                s.calls += 1
                s.seconds += dt
                s.samples += samples
                s.frames += frames

    def count(self, name: str, samples: int = 0, frames: int = 0, calls: int = 1):
        """Attribute counts to a stage without timing it."""
        with self._lock:
            s = self._get(name)
            s.calls += calls
            s.samples += samples
            s.frames += frames

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
    points = torch.as_tensor(params.constellation(int(params.MCS_N_BPSC[mcs])),
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
