"""Wire formats: host-side quantization and device-side decode.

Host side (numpy) quantizes float32 real/imag pairs to the configured wire
format; device side (torch) turns wire pairs back into complex64. Complex
data crosses into a kernel as ``torch.view_as_real(x)`` float32 pairs.
The full scales are the JAX package's (utils/xfer.py:41,56).
``quantize_wire_into`` writes ``quantize_wire``'s bytes into a buffer the
caller gives: in one pass of the native library (runtime/native.py) where
it loads, by a copy of ``quantize_wire``'s result where it does not.
``WirePool`` runs it on threads of its own over segments of a stream's
rows; ``wire_pool()`` is the process's pool, which the CUDA executors
stage through (parallel/executor.py ``_pad_wire``).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch


def to_riq(x: np.ndarray) -> np.ndarray:
    """Host-side: complex array -> float32 (..., 2) real/imag pairs."""
    x = np.asarray(x)
    if x.dtype == np.complex64:
        # complex64 memory is interleaved (re, im) float32 pairs: a view
        return np.ascontiguousarray(x).view(np.float32).reshape(x.shape + (2,))
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def from_riq(x: torch.Tensor) -> torch.Tensor:
    """float32 (..., 2) -> complex64 (...)."""
    return torch.view_as_complex(x.to(torch.float32).contiguous())


# "sc16": int16 I/Q pairs, UHD's native over-the-wire format.
SC16_FULL_SCALE = 4.0


def quantize_sc16(riq: np.ndarray) -> np.ndarray:
    """Host-side: float32 (..., 2) riq -> int16 (..., 2) wire samples."""
    k = 32767.0 / SC16_FULL_SCALE
    return np.clip(np.round(riq * k), -32768, 32767).astype(np.int16)


# "sc8": int8 I/Q pairs, the HackRF's native ADC format.
SC8_FULL_SCALE = 2.0


def quantize_sc8(riq: np.ndarray) -> np.ndarray:
    """Host-side: float32 (..., 2) riq -> int8 (..., 2) wire samples."""
    k = 127.0 / SC8_FULL_SCALE
    return np.clip(np.round(riq * k), -128, 127).astype(np.int8)


WIRE_DTYPES = {"f32": np.float32, "sc16": np.int16, "sc8": np.int8}
WIRE_TORCH_DTYPES = {"f32": torch.float32, "sc16": torch.int16, "sc8": torch.int8}


def quantize_wire(riq: np.ndarray, wire_format: str) -> np.ndarray:
    """Host-side: apply the configured wire format to float32 riq pairs.
    Unknown formats raise."""
    if wire_format == "sc16":
        return quantize_sc16(riq)
    if wire_format == "sc8":
        return quantize_sc8(riq)
    if wire_format == "f32":
        return riq
    raise ValueError(
        f"unknown wire_format {wire_format!r}: expected f32, sc16 or sc8")


def quantize_wire_into(riq: np.ndarray, wire_format: str, out: np.ndarray) -> None:
    """Host-side: ``quantize_wire(riq, wire_format)`` written into ``out``,
    a C-contiguous wire array of riq's shape and the format's dtype, byte
    for byte. The native quantizer reads riq once and writes out once;
    without the library ``quantize_wire``'s result is copied into out."""
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native

    if wire_format not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_format {wire_format!r}: expected f32, sc16 or sc8")
    riq = np.ascontiguousarray(riq, dtype=np.float32)
    if (out.shape != riq.shape or out.dtype != WIRE_DTYPES[wire_format]
            or not out.flags.c_contiguous):
        raise ValueError(
            f"quantize_wire_into: riq {riq.shape} into out {out.dtype} {out.shape}: "
            f"expected a C-contiguous {np.dtype(WIRE_DTYPES[wire_format])} array of "
            f"riq's shape")
    if native.available():
        native._quantize_wire(riq, wire_format, out)
    else:
        np.copyto(out, quantize_wire(riq, wire_format))


# The staging pool's size and its smallest segment, from a table taken on
# an H100 host (8 cores, the benchmark's six "rest" cores; PERF.md §6): a
# (4, 4 194 304) stream to sc16 took 21-25 ms on one thread and 4.9-8.0 ms
# on six, the best of 1-6; a segment of 2**19 samples takes one thread
# about 0.27 ms, more than the 0.2 ms a parked thread takes to wake and
# answer, so no shorter segment leaves the calling thread.
WIRE_WORKERS = 6
WIRE_MIN_SEGMENT = 1 << 19


class _Segment:
    """One segment of a row: quantized on a worker, waited for and its
    error re-raised on the thread that handed it out."""

    __slots__ = ("src", "fmt", "out", "done", "error")

    def __init__(self, src: np.ndarray, fmt: str, out: np.ndarray):
        self.src, self.fmt, self.out = src, fmt, out
        self.done = threading.Event()
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            quantize_wire_into(to_riq(self.src), self.fmt, self.out)
        except BaseException as e:      # handed to the waiting thread
            self.error = e
        finally:
            self.done.set()


class WirePool:
    """Threads that quantize a stream's rows in segments. The threads start
    in the constructor and so run on the cores of the thread that builds
    the pool; the native quantizer releases the GIL, so they quantize in
    parallel. ``quantize_rows`` hands out every segment of every row at
    once and reports each segment back on the calling thread, in order, as
    it completes."""

    def __init__(self, workers: int):
        self._tasks: queue.SimpleQueue = queue.SimpleQueue()
        self.threads = [threading.Thread(target=self._work, name=f"wire-quantize-{i}",
                                         daemon=True) for i in range(workers)]
        for t in self.threads:
            t.start()

    def _work(self) -> None:
        while (task := self._tasks.get()) is not None:
            task.run()

    def close(self) -> None:
        for _ in self.threads:
            self._tasks.put(None)
        for t in self.threads:
            t.join()

    def quantize_rows(self, x: np.ndarray, wire_format: str, out: np.ndarray,
                      on_part=None, min_segment: int = WIRE_MIN_SEGMENT) -> int:
        """``quantize_wire(to_riq(x[ch]), wire_format)`` into ``out[ch]`` for
        each row of the (C, n) complex stream ``x``; ``out`` is (C, n, 2)
        with C-contiguous rows. Each row is cut into as many segments as
        there are threads, none shorter than ``min_segment`` samples (one
        segment a row where n is below twice that). ``on_part(ch, lo, hi)``
        runs on the calling thread for each finished segment, row after row.
        A worker's exception is raised here once every segment has ended, so
        no worker writes into ``out`` after the return. Returns the number
        of segments."""
        c, n = x.shape
        parts = max(1, min(len(self.threads), n // min_segment))
        cuts = [n * k // parts for k in range(parts + 1)]
        segs = [(ch, lo, hi, _Segment(x[ch, lo:hi], wire_format, out[ch, lo:hi]))
                for ch in range(c) for lo, hi in zip(cuts, cuts[1:])]
        for *_, seg in segs:
            self._tasks.put(seg)
        try:
            for ch, lo, hi, seg in segs:
                seg.done.wait()
                if seg.error is not None:
                    raise seg.error
                if on_part is not None:
                    on_part(ch, lo, hi)
        finally:
            for *_, seg in segs:
                seg.done.wait()
        return len(segs)


_pool: WirePool | None = None
_pool_lock = threading.Lock()


def wire_pool() -> WirePool:
    """The process's staging pool, started by the first caller (on that
    thread's cores) with ``WIRE_WORKERS`` threads, or fewer where the
    process may run on fewer cores."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = WirePool(min(WIRE_WORKERS, len(os.sched_getaffinity(0))))
        return _pool


def from_wire(x: torch.Tensor) -> torch.Tensor:
    """Wire pairs (..., 2) in any wire format -> complex64 (...)."""
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * (SC16_FULL_SCALE / 32767.0)
    elif x.dtype == torch.int8:
        x = x.to(torch.float32) * (SC8_FULL_SCALE / 127.0)
    return from_riq(x)
