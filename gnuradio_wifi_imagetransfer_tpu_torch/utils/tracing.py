"""Observability for the port: per-stage counters and timers, and the
per-frame EVM SNR probe (the parts of the JAX package's utils/tracing.py
that the streaming executor uses)."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    samples: int = 0
    frames: int = 0


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
