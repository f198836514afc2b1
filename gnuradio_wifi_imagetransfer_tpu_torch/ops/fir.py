"""Causal FIR filter and polyphase rational resampler: CUDA kernel wrappers
and plain versions.

Replaces the JAX package's TPU kernels in ops/pallas_fir.py:

    fir_filter          K3, ``_fir_kernel`` reached through ``_fir_real``'s
                        pl.pallas_call (two banded 128x128 matmuls a tile)
    polyphase_resample  K4, ``_resample_kernel`` reached through
                        ``_resample_real``'s pl.pallas_call (static
                        (L, M+2, 128, 128) tables, L <= 64 and M <= 96)

Both kernels are in ``csrc/fir.cu``; each takes all rows in one launch and
reads complex samples as interleaved float2. K3 is a persistent stencil
over tiles of 2048 outputs, their windows staged by cp.async in a
two-buffer ring, 16 outputs a thread, the taps in chunks of up to 256
through shared memory. K4 stages a tile's input span in shared memory
and reads taps from the phase-major table of ``phase_table`` (built once
per taps, ratio and device, and again only when tensor taps change);
``resample_geometry`` picks its tile. The designs are in the source's
notes; ``fir_bound`` and ``resample_bound`` are the kernels' bounds.

The plain versions are the JAX package's XLA oracles (ops/resampler.py
``fir_filter`` and ``polyphase_resample``) in PyTorch, summed in tap
order. They index in int64: the JAX path forms ``j * decim`` in int32,
which wraps once it passes 2**31 (at L/M = 25001/25000, the 40 ppm ratio,
from output 85 900 on; at the 20001/20000 of ``correct_sample_clock(x,
40.0)`` from output 107 375 on).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build, roofline

_DTYPES = (torch.float32, torch.complex64)

# K4 (csrc/fir.cu): outputs a tile at most, shared-memory room for a
# tile's input span and for the phase table
RS_MAX_TILE = 2048
RS_SPAN_BYTES = 48 * 1024
RS_TABLE_BYTES = 16 * 1024
# the kernel steps phases and bases in 32 bits
RS_MAX_TERM = 1 << 30


@functools.lru_cache(maxsize=32)
def _taps_on(key: bytes, device: torch.device) -> torch.Tensor:
    """One upload per (taps, device): later calls reuse the device copy."""
    return torch.frombuffer(bytearray(key), dtype=torch.float32).to(device)


def _taps_tensor(taps, device: torch.device) -> torch.Tensor:
    """(K,) float32 taps on ``device``; numpy taps are uploaded once and
    cached, so a repeated call makes no host-to-device copy."""
    if isinstance(taps, torch.Tensor):
        h = taps.to(device=device, dtype=torch.float32).contiguous()
    else:
        arr = np.ascontiguousarray(taps, dtype=np.float32)
        h = (torch.from_numpy(arr) if device.type == "cpu"
             else _taps_on(arr.tobytes(), device))
    if h.ndim != 1 or h.numel() == 0:
        raise ValueError(f"taps must be a non-empty 1-D array, got shape {tuple(h.shape)}")
    return h


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: expected float32 or complex64, got {x.dtype}")
    if x.ndim < 1:
        raise ValueError(f"{name}: expected (..., N), got a scalar")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _ptr(x: torch.Tensor) -> int:
    return (torch.view_as_real(x) if x.is_complex() else x).data_ptr()


# ----------------------------------------------------------------------
# K3: causal FIR
# ----------------------------------------------------------------------


def fir_filter_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """y[..., n] = sum_{t<K} h[t] * x[..., n - t], zeros before the row's
    start (ops/resampler.py fir_filter of the JAX package)."""
    h = _taps_tensor(taps, x.device)
    k, n = h.numel(), x.shape[-1]
    xp = torch.cat([x.new_zeros(x.shape[:-1] + (k - 1,)), x], dim=-1)
    y = torch.zeros_like(x)
    for t in range(k):
        y += h[t] * xp[..., k - 1 - t: k - 1 - t + n]
    return y


def fir_filter(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR along the last axis: (..., N) float32 or complex64 and
    (K,) real taps -> (..., N) of x's dtype.

    A CUDA tensor goes through the kernel (one launch for all rows); a CPU
    tensor through ``fir_filter_plain``. The kernel reads the taps on the
    device, so the call does not wait for the device."""
    if x.device.type == "cpu":
        return fir_filter_plain(x, taps)
    _check("fir_filter", x)
    h = _taps_tensor(taps, x.device)
    y = torch.empty_like(x)
    n = x.shape[-1]
    if x.numel() == 0:
        return y
    err = build.library().gwt_fir(
        _ptr(x), h.data_ptr(), _ptr(y), x.numel() // n, n, h.numel(), int(x.is_complex()),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fir_filter")
    build.count_launch(fir_filter, (x, taps))
    return y


fir_filter.launches = 0


# ----------------------------------------------------------------------
# K4: polyphase rational resampler
# ----------------------------------------------------------------------


def out_len(n: int, interp: int, decim: int) -> int:
    """ceil(n * L / M), in exact integers."""
    return -(-n * interp // decim)


def polyphase_resample_plain(x: torch.Tensor, interp: int, decim: int,
                             taps) -> torch.Tensor:
    """Rational L/M resampling along the last axis, the oracle's direct
    form (ops/resampler.py polyphase_resample of the JAX package):

        c = (n_taps - 1) // 2,  t0 = (j*M + c) mod L,  base = (j*M + c - t0) / L
        y[j] = sum_{k < ceil(n_taps/L)} h[t0 + k*L] * x[base - k]

    over the terms with t0 + k*L < n_taps and 0 <= base - k < N. Indices
    are int64, so j*M is exact at any length."""
    h = _taps_tensor(taps, x.device)
    n, n_taps = x.shape[-1], h.numel()
    n_out = out_len(n, interp, decim)
    j = torch.arange(n_out, dtype=torch.int64, device=x.device)
    up = j * decim + (n_taps - 1) // 2
    t0 = up % interp
    base = (up - t0) // interp
    y = x.new_zeros(x.shape[:-1] + (n_out,))
    for k in range(-(-n_taps // interp)):
        tap, src = t0 + k * interp, base - k
        valid = (tap < n_taps) & (src >= 0) & (src < n)
        coef = torch.where(valid, h[tap.clamp(max=n_taps - 1)], 0.0)
        y += coef * x.index_select(-1, src.clamp(0, n - 1))
    return y


def phase_table(h: torch.Tensor, interp: int) -> torch.Tensor:
    """The phase-major tap table K4 reads: hp[p, k] = h[p + k*L], zero
    where p + k*L >= n_taps; (L, ceil(n_taps/L)) float32."""
    kp = -(-h.numel() // interp)
    return torch.nn.functional.pad(h, (0, interp * kp - h.numel())).reshape(
        kp, interp).t().contiguous()


@functools.lru_cache(maxsize=32)
def _phase_table_on(key: bytes, interp: int, device: torch.device) -> torch.Tensor:
    """One table per (taps, L, device): later calls reuse the device copy."""
    h = torch.frombuffer(bytearray(key), dtype=torch.float32)
    return phase_table(h, interp).to(device)


# tensor taps -> {(L, device): (the taps' version, table)}; an entry goes
# with its taps
_tensor_tables: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _phase_table_of(taps: torch.Tensor, interp: int, device: torch.device) -> torch.Tensor:
    """The phase table of tensor taps on ``device``, rebuilt only after the
    taps change in place (their version counter moves): a repeated call
    makes no copy and launches nothing."""
    per = _tensor_tables.setdefault(taps, {})
    version, table = per.get((interp, device), (None, None))
    if version != taps._version:
        table = phase_table(_taps_tensor(taps.detach(), device), interp)
        per[(interp, device)] = (taps._version, table)
    return table


def resample_geometry(n_taps: int, interp: int, decim: int,
                      itemsize: int) -> tuple[int, int, int, int, bool]:
    """K4's launch geometry for samples of ``itemsize`` bytes:
    (kp, kc, tile, span_bytes, table_in_smem).

    kp taps a phase; kc of them a pass (all of them unless a phase row
    outgrows half the span room); tile outputs a block, the largest power
    of two up to RS_MAX_TILE whose input span fits RS_SPAN_BYTES; the
    shared bytes kept for that span (16-byte aligned, with room for the
    alignment of its first copy); and whether the (L, kp) table fits
    RS_TABLE_BYTES of shared memory."""
    v = 16 // itemsize
    kp = -(-n_taps // interp)
    room = RS_SPAN_BYTES // itemsize - 2 * v
    kc = min(kp, room // 2)

    def span(t):            # most that base(j0 + t - 1) - base(j0) can be
        return ((t - 1) * decim + interp - 1) // interp

    tile = RS_MAX_TILE
    while tile > 1 and span(tile) + kc > room:
        tile //= 2
    span_bytes = -(-(span(tile) + kc + 2 * v) * itemsize // 16) * 16
    return kp, kc, tile, span_bytes, interp * kp * 4 <= RS_TABLE_BYTES


def polyphase_resample(x: torch.Tensor, interp: int, decim: int, taps) -> torch.Tensor:
    """Rational L/M resampling along the last axis: (..., N) float32 or
    complex64 -> (..., ceil(N*L/M)), with the oracle's centering (output j
    sits at input time j*M/L).

    A CUDA tensor goes through the kernel (one launch for all rows), with
    the taps as ``phase_table`` lays them out (built once per taps, ratio
    and device); a CPU tensor through ``polyphase_resample_plain``."""
    if x.device.type == "cpu":
        return polyphase_resample_plain(x, interp, decim, taps)
    _check("polyphase_resample", x)
    if not (1 <= interp < RS_MAX_TERM and 1 <= decim < RS_MAX_TERM):
        raise ValueError(f"polyphase_resample: ratio terms must be in [1, 2**30), "
                         f"got {(interp, decim)}")
    if isinstance(taps, torch.Tensor):
        hp, n_taps = _phase_table_of(taps, interp, x.device), taps.numel()
    else:
        arr = np.ascontiguousarray(taps, dtype=np.float32)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"taps must be a non-empty 1-D array, got shape {arr.shape}")
        hp, n_taps = _phase_table_on(arr.tobytes(), interp, x.device), arr.size
    n = x.shape[-1]
    n_out = out_len(n, interp, decim)
    y = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    kp, kc, tile, span_bytes, in_smem = resample_geometry(
        n_taps, interp, decim, x.element_size())
    err = build.library().gwt_polyphase_resample(
        _ptr(x), hp.data_ptr(), _ptr(y), y.numel() // n_out, n, n_out, n_taps,
        interp, decim, kp, kc, tile, span_bytes, int(in_smem), int(x.is_complex()),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "polyphase_resample")
    build.count_launch(polyphase_resample, (x, interp, decim, taps))
    return y


polyphase_resample.launches = 0


# Bounds (ms on the card, ``roofline``)
# ----------------------------------------------------------------------

# a real tap on a complex sample: 2 multiplies + 2 adds, two fused
# multiply-adds, so the FMA rate
OPS_PER_COMPLEX_TAP = 4


def fir_bound(n: int, taps: int) -> dict:
    """K3's bound on n complex64 samples (all rows) with ``taps`` real
    taps: each sample read and each output written once, the taps read
    once; every tap on every sample."""
    return roofline.bound(n * (8 + 8) + taps * 4, n * taps * OPS_PER_COMPLEX_TAP,
                          roofline.FP32_FMA_OPS_PER_S)


def resample_terms(n: int, interp: int, decim: int, n_taps: int) -> int:
    """The terms that ``polyphase_resample_plain``'s direct form sums for a
    row of n samples: a tap index inside the taps, a sample index inside
    the row."""
    n_out = out_len(n, interp, decim)
    up = np.arange(n_out, dtype=np.int64) * decim + (n_taps - 1) // 2
    t0 = up % interp
    base = up // interp
    return sum(int(((t0 + k * interp < n_taps) & (base - k >= 0) & (base - k < n)).sum())
               for k in range(-(-n_taps // interp)))


def resample_bound(n_in: int, n_out: int, n_taps: int, terms: int) -> dict:
    """K4's bound for n_in complex64 samples in and n_out out (all rows)
    with n_taps real taps and ``terms`` tap-sample products in all
    (``resample_terms`` a row): each sample read, each output written and
    each tap read once."""
    return roofline.bound((n_in + n_out) * 8 + n_taps * 4, terms * OPS_PER_COMPLEX_TAP,
                          roofline.FP32_FMA_OPS_PER_S)
