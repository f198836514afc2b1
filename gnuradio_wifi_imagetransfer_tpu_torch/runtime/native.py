"""ctypes loader and wrappers for the native host runtime (csrc/gwt_native.cpp).

The reference's host runtime is C++: GNU Radio's ring-buffer scheduler,
the socket_pdu UDP bridge (IRS_user.grc:299-318) and the ieee802_11.mac
framer/CRC (IRS_user.py:192). This module builds the port's copy of the
C++ source that the JAX package's runtime/native.py builds
(native/gwt_native.cpp), with the same Python surface; the copy's UDP
source also stamps each datagram's receive time and counts its drops:

    RingBuffer       lock-free SPSC complex64 sample ring
    NativeUdpSource  threaded UDP PDU receiver (GIL-free recv loop)
    NativeUdpSink    UDP datagram sender
    crc32 / frame_batch / check_fcs_batch / scatter_bursts   host hot loops

The shared library is compiled with g++ at first use into the package's
``_build/`` directory (git-ignored), under a name that carries a hash of
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. g++ writes to a temporary name in that directory
and the result is renamed into place, so a process that builds at the same
time as another never loads a half-written library. ``available()``
reports whether the native path is usable; callers keep a pure-Python
path (phy/mac.py, runtime/bridge.py), so correctness never depends on the
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.ops.build import BUILD_DIR

SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "gwt_native.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return pathlib.Path(build_dir) / f"libgwt_native_{h.hexdigest()[:16]}.so"


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the native source into build_dir (cached by content).
    Raises OSError or subprocess.CalledProcessError when g++ is missing
    or fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=".tmp_", suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)            # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def bind(path) -> ctypes.CDLL:
    """Load the library at path and declare every entry point's types."""
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp, i64, u64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int

    lib.gwt_crc32.restype = ctypes.c_uint32
    lib.gwt_crc32.argtypes = [u8p, i64]
    lib.gwt_frame_batch.restype = None
    lib.gwt_frame_batch.argtypes = [u8p, i64, i64, ctypes.c_uint32, u8p, u8p, u8p, u8p]
    lib.gwt_check_fcs_batch.restype = None
    lib.gwt_check_fcs_batch.argtypes = [u8p, i64, i64, u8p]

    lib.gwt_ring_create.restype = vp
    lib.gwt_ring_create.argtypes = [u64]
    lib.gwt_ring_destroy.restype = None
    lib.gwt_ring_destroy.argtypes = [vp]
    for name in ("gwt_ring_capacity", "gwt_ring_available", "gwt_ring_space"):
        fn = getattr(lib, name)
        fn.restype = u64
        fn.argtypes = [vp]
    lib.gwt_ring_write.restype = u64
    lib.gwt_ring_write.argtypes = [vp, f32p, u64]
    lib.gwt_ring_read.restype = u64
    lib.gwt_ring_read.argtypes = [vp, f32p, u64]

    lib.gwt_udp_source_create.restype = vp
    lib.gwt_udp_source_create.argtypes = [ctypes.c_char_p, cint, cint, cint]
    lib.gwt_udp_source_port.restype = cint
    lib.gwt_udp_source_port.argtypes = [vp]
    lib.gwt_udp_source_drain.restype = cint
    lib.gwt_udp_source_drain.argtypes = [vp, u8p, i64, i32p, i64p, cint, cint]
    lib.gwt_udp_source_dropped.restype = i64
    lib.gwt_udp_source_dropped.argtypes = [vp]
    lib.gwt_udp_source_destroy.restype = None
    lib.gwt_udp_source_destroy.argtypes = [vp]
    lib.gwt_udp_sink_create.restype = vp
    lib.gwt_udp_sink_create.argtypes = [ctypes.c_char_p, cint]
    lib.gwt_udp_sink_send.restype = cint
    lib.gwt_udp_sink_send.argtypes = [vp, u8p, i64]
    lib.gwt_udp_sink_destroy.restype = None
    lib.gwt_udp_sink_destroy.argtypes = [vp]

    lib.gwt_scatter_bursts.restype = None
    lib.gwt_scatter_bursts.argtypes = [f32p, i64, i64, i64p, ctypes.c_float, f32p, i64]
    return lib


def _load() -> ctypes.CDLL | None:
    """The process's library, built and bound once; None when the
    toolchain is missing or the build fails."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = bind(build())
            except (OSError, subprocess.SubprocessError):
                _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ missing or the build failed)")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# Host hot loops
# ---------------------------------------------------------------------------


def crc32(data: bytes | np.ndarray) -> int:
    lib = _library()
    buf = (np.ascontiguousarray(data, dtype=np.uint8) if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    return int(lib.gwt_crc32(_u8(buf), buf.size))


def _mac_address(a: bytes) -> np.ndarray:
    if len(a) != 6:
        raise ValueError("MAC addresses must be 6 bytes")
    return np.frombuffer(bytes(a), dtype=np.uint8)


def frame_batch(payloads: np.ndarray, seq0: int, src: bytes, dst: bytes,
                bss: bytes) -> np.ndarray:
    """(B, L) payload bytes -> (B, L+28) MPDUs (native fast path)."""
    lib = _library()
    p = np.ascontiguousarray(payloads, dtype=np.uint8)
    if p.ndim != 2:
        raise ValueError(f"frame_batch: expected (B, L) payloads, got {p.shape}")
    b, l = p.shape
    out = np.empty((b, l + 28), dtype=np.uint8)
    addrs = [_mac_address(a) for a in (src, dst, bss)]
    lib.gwt_frame_batch(_u8(p), b, l, seq0 & 0xFFF, *map(_u8, addrs), _u8(out))
    return out


def check_fcs_batch(mpdus: np.ndarray) -> np.ndarray:
    """(B, n) MPDUs -> (B,) bool FCS validity."""
    lib = _library()
    m = np.ascontiguousarray(mpdus, dtype=np.uint8)
    if m.ndim != 2 or m.shape[1] < 4:
        raise ValueError(f"check_fcs_batch: expected (B, n >= 4) MPDUs, got {m.shape}")
    b, n = m.shape
    ok = np.empty(b, dtype=np.uint8)
    lib.gwt_check_fcs_batch(_u8(m), b, n, _u8(ok))
    return ok.astype(bool)


def scatter_bursts(bursts: np.ndarray, positions: np.ndarray, n_out: int,
                   scale: float = 1.0) -> np.ndarray:
    """(B, L) complex64 bursts + (B,) start samples -> (n_out,) stream."""
    lib = _library()
    bb = np.ascontiguousarray(bursts, dtype=np.complex64)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    if bb.ndim != 2 or pos.shape != (bb.shape[0],):
        raise ValueError(f"scatter_bursts: bursts {bb.shape}, positions {pos.shape}")
    out = np.empty(n_out, dtype=np.complex64)
    lib.gwt_scatter_bursts(
        _f32(bb.view(np.float32)), bb.shape[0], bb.shape[1],
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        float(scale), _f32(out.view(np.float32)), n_out)
    return out


# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------


class RingBuffer:
    """SPSC lock-free complex64 sample ring (GNU Radio buffer analogue)."""

    def __init__(self, capacity: int):
        self._lib = _library()
        self._h = self._lib.gwt_ring_create(capacity)

    @property
    def capacity(self) -> int:
        return int(self._lib.gwt_ring_capacity(self._h))

    def available(self) -> int:
        return int(self._lib.gwt_ring_available(self._h))

    def space(self) -> int:
        return int(self._lib.gwt_ring_space(self._h))

    def write(self, samples: np.ndarray) -> int:
        x = np.ascontiguousarray(samples, dtype=np.complex64)
        return int(self._lib.gwt_ring_write(self._h, _f32(x.view(np.float32)), x.size))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.complex64)
        got = int(self._lib.gwt_ring_read(self._h, _f32(out.view(np.float32)), n))
        return out[:got]

    def close(self):
        if self._h:
            self._lib.gwt_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


# ---------------------------------------------------------------------------
# UDP PDU bridge
# ---------------------------------------------------------------------------


class NativeUdpSource:
    """socket_pdu('UDP_SERVER') equivalent with a C++ receive thread (it
    starts at construction: datagrams queue from then on)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 mtu: int = 10000, max_queue: int = 4096):
        self._lib = _library()
        self._h = self._lib.gwt_udp_source_create(host.encode(), port, mtu, max_queue)
        if not self._h:
            raise OSError(f"could not bind UDP {host}:{port}")
        self.mtu = mtu

    @property
    def port(self) -> int:
        return int(self._lib.gwt_udp_source_port(self._h))

    def start(self):
        return self  # thread starts at construction; API parity with bridge

    @property
    def dropped(self) -> int:
        """Datagrams discarded so far because ``max_queue`` were queued
        (the newest are kept)."""
        return int(self._lib.gwt_udp_source_dropped(self._h))

    def drain(self, max_items: int, timeout: float = 0.05,
              stamps: np.ndarray | None = None) -> list[bytes]:
        """Up to max_items queued datagrams, waiting up to timeout for the
        first. With ``stamps`` (an int64 array of at least max_items), each
        datagram's receive time, ``time.monotonic_ns()``'s clock, goes into
        its first entries."""
        buf = np.empty(max_items * self.mtu, dtype=np.uint8)
        lens = np.empty(max_items, dtype=np.int32)
        if stamps is not None and (stamps.dtype != np.int64 or stamps.size < max_items
                                   or not stamps.flags.c_contiguous):
            raise ValueError("drain: stamps must be a contiguous int64 array of max_items")
        n = int(self._lib.gwt_udp_source_drain(
            self._h, _u8(buf), buf.size,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            None if stamps is None else stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_items, int(timeout * 1000)))
        out, off = [], 0
        for i in range(n):
            out.append(bytes(buf[off:off + lens[i]]))
            off += int(lens[i])
        return out

    def stop(self):
        if self._h:
            self._lib.gwt_udp_source_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.stop()


class NativeUdpSink:
    """UDP datagram sender (Extract-Pics forwarding path)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10010):
        self._lib = _library()
        self._h = self._lib.gwt_udp_sink_create(host.encode(), port)
        if not self._h:
            raise OSError("could not create UDP sink")

    def send(self, data: bytes) -> None:
        buf = np.frombuffer(data, dtype=np.uint8)
        self._lib.gwt_udp_sink_send(self._h, _u8(buf), buf.size)

    def close(self):
        if self._h:
            self._lib.gwt_udp_sink_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
