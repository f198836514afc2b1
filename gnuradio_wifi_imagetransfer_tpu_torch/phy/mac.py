"""802.11 MAC framing: data-MPDU framer, CRC-32 FCS, header parser.

PyTorch port of the JAX package's phy/mac.py (ieee802_11.mac and
decode_mac's CRC check / parse_mac): a 24-byte data-frame MAC header
(frame control 0x0008, duration 0x002E, addr1/2/3, incrementing 12-bit
sequence number) around the payload, with a little-endian CRC-32 FCS. The
reference instantiates src/dst/bss = 0x23*6 / 0x42*6 / 0xff*6.

Two CRC-32 paths:
  * the host path (zlib) for framing and validation in the app;
  * ``crc32`` / ``check_fcs_batch``, a batched byte-table CRC on the
    tensor's device, so a decoded frame batch is checked without a trip
    to the host. torch has no full uint32 arithmetic, so it runs in int64
    (every value stays below 2**32).

``frame_batch`` takes the native C++ framer (runtime/native.py) when the
toolchain is available, as the JAX package's does, and the numpy + zlib
framer otherwise; both give the same bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
import zlib

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table

HEADER_LEN = 24
FCS_LEN = 4

DEFAULT_SRC = bytes([0x23] * 6)
DEFAULT_DST = bytes([0x42] * 6)
DEFAULT_BSS = bytes([0xFF] * 6)

FRAME_CONTROL = 0x0008   # data frame
DURATION = 0x002E

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class MacFrame:
    frame_control: int
    duration: int
    addr1: bytes
    addr2: bytes
    addr3: bytes
    seq_no: int
    payload: bytes
    fcs_ok: bool


class Mac:
    """Stateful framer mirroring ieee802_11.mac: the sequence number
    increments per frame (12-bit wraparound)."""

    def __init__(self, src: bytes = DEFAULT_SRC, dst: bytes = DEFAULT_DST,
                 bss: bytes = DEFAULT_BSS):
        if not (len(src) == len(dst) == len(bss) == 6):
            raise ValueError("MAC addresses must be 6 bytes")
        self.src, self.dst, self.bss = bytes(src), bytes(dst), bytes(bss)
        self.seq_no = 0

    def frame(self, payload: bytes) -> bytes:
        """payload -> MPDU (header + payload + FCS)."""
        hdr = struct.pack("<HH6s6s6sH", FRAME_CONTROL, DURATION, self.dst, self.src,
                          self.bss, (self.seq_no & 0xFFF) << 4)
        self.seq_no = (self.seq_no + 1) & 0xFFF
        body = hdr + payload
        return body + struct.pack("<I", zlib.crc32(body) & _MASK32)


def parse(mpdu: bytes) -> MacFrame:
    """Validate the FCS and split an MPDU (decode_mac's CRC + parse_mac)."""
    if len(mpdu) < HEADER_LEN + FCS_LEN:
        raise ValueError(f"MPDU too short: {len(mpdu)} bytes")
    body, fcs = mpdu[:-FCS_LEN], mpdu[-FCS_LEN:]
    fcs_ok = struct.unpack("<I", fcs)[0] == (zlib.crc32(body) & _MASK32)
    fc, dur, a1, a2, a3, seq = struct.unpack("<HH6s6s6sH", body[:HEADER_LEN])
    return MacFrame(frame_control=fc, duration=dur, addr1=a1, addr2=a2, addr3=a3,
                    seq_no=seq >> 4, payload=body[HEADER_LEN:], fcs_ok=fcs_ok)


def frame_batch(payloads: np.ndarray, seq0: int = 0,
                src: bytes = DEFAULT_SRC, dst: bytes = DEFAULT_DST,
                bss: bytes = DEFAULT_BSS) -> np.ndarray:
    """Vectorized framer: (B, L) payload bytes -> (B, L+28) MPDUs with
    consecutive sequence numbers starting at seq0: the native framer when
    ``native.available()``, else ``frame_batch_numpy``."""
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native

    if native.available():
        return native.frame_batch(payloads, seq0, src, dst, bss)
    return frame_batch_numpy(payloads, seq0, src, dst, bss)


def frame_batch_numpy(payloads: np.ndarray, seq0: int = 0,
                      src: bytes = DEFAULT_SRC, dst: bytes = DEFAULT_DST,
                      bss: bytes = DEFAULT_BSS) -> np.ndarray:
    """``frame_batch`` in numpy + zlib."""
    b, l = payloads.shape
    out = np.empty((b, HEADER_LEN + l + FCS_LEN), dtype=np.uint8)
    out[:, :22] = np.frombuffer(
        struct.pack("<HH6s6s6s", FRAME_CONTROL, DURATION, dst, src, bss), dtype=np.uint8)
    seqs = ((seq0 + np.arange(b)) & 0xFFF) << 4
    out[:, 22] = seqs & 0xFF
    out[:, 23] = seqs >> 8
    out[:, 24: 24 + l] = payloads
    for i in range(b):
        crc = zlib.crc32(out[i, : 24 + l].tobytes()) & _MASK32
        out[i, 24 + l:] = np.frombuffer(struct.pack("<I", crc), dtype=np.uint8)
    return out


@functools.cache
def _crc32_table64() -> np.ndarray:
    return params.crc32_table().astype(np.int64)


def crc32(data: torch.Tensor) -> torch.Tensor:
    """Batched CRC-32 (IEEE, reflected): (..., n) uint8 -> (...,) int64
    holding the uint32 value, on data's device. The whole batch advances
    one byte a step, so the loop is as long as a frame."""
    table = device_table(_crc32_table64, device=data.device)
    x = data.to(torch.int64)
    crc = torch.full(x.shape[:-1], _MASK32, dtype=torch.int64, device=data.device)
    for i in range(x.shape[-1]):
        crc = (crc >> 8) ^ table[(crc ^ x[..., i]) & 0xFF]
    return crc ^ _MASK32


def check_fcs_batch(mpdus: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 MPDUs -> (B,) bool FCS validity, on their device."""
    fcs = mpdus[..., -FCS_LEN:].to(torch.int64)
    stored = fcs[..., 0] | (fcs[..., 1] << 8) | (fcs[..., 2] << 16) | (fcs[..., 3] << 24)
    return crc32(mpdus[..., :-FCS_LEN]) == stored
