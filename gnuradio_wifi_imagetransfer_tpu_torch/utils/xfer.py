"""Wire formats: host-side quantization and device-side decode.

Host side (numpy) quantizes float32 real/imag pairs to the configured wire
format; device side (torch) turns wire pairs back into complex64. Complex
data crosses into a kernel as ``torch.view_as_real(x)`` float32 pairs.
The full scales are the JAX package's (utils/xfer.py:41,56).
"""

from __future__ import annotations

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


def from_wire(x: torch.Tensor) -> torch.Tensor:
    """Wire pairs (..., 2) in any wire format -> complex64 (...)."""
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * (SC16_FULL_SCALE / 32767.0)
    elif x.dtype == torch.int8:
        x = x.to(torch.float32) * (SC8_FULL_SCALE / 127.0)
    return from_riq(x)
