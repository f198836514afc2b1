"""Fused STF detector statistics: CUDA kernel wrapper and plain version.

Replaces the JAX package's TPU kernel ops/pallas_sync.py (``_kernel``,
reached through ``_stats_1d``'s pl.pallas_call; wrapper ``sync_stats``).
The kernel is ``csrc/sync_stats.cu``: one launch for the whole (rows, N)
batch, direct window sums per output, exact zeros over silent windows. It
is bound by device memory: 24 bytes a sample (see the source's note).

``sync_stats_plain`` is the JAX package's XLA path (phy/sync.py:87-123) in
PyTorch: a delay-16 conjugate product and segmented moving sums.
"""

from __future__ import annotations

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build


def _moving_sum(v: torch.Tensor, w: int, seg: int = 512) -> torch.Tensor:
    """Trailing moving sum of width w along the last axis, from SEGMENTED
    cumulative sums (phy/sync.py:95-123 of the JAX package): a global
    cumsum difference cancels catastrophically in float32 over long
    streams and leaves residue in silent stretches, which produced false
    sync edges. Local seg-sample rows bound every window sum by one row's
    energy and make it exactly 0 where the window is silent.

    The sums are taken in double precision and rounded once at the end:
    the float32 cumsums of the JAX path are off by a few ulps of a row's
    energy, and two such paths with different rounding disagree by more
    than the tolerance the JAX tests hold the Pallas kernel to."""
    assert w <= seg
    n = v.shape[-1]
    pad = (-n) % seg
    wide = torch.complex128 if v.is_complex() else torch.float64
    vp = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1).to(wide)
    rows = vp.reshape(vp.shape[:-1] + (-1, seg))              # (..., R, S)
    c = torch.cumsum(rows, dim=-1)
    prev_c = torch.roll(c, 1, dims=-2)
    prev_c[..., 0, :] = 0                                     # previous row's cumsum
    prev_tot = prev_c[..., -1:]                               # (..., R, 1)
    j = torch.arange(seg, device=v.device)
    jmw = j - w
    within = jmw >= 0
    sub_in = c.index_select(-1, jmw.clamp(min=0))             # window inside the row
    sub_prev = prev_c.index_select(-1, (jmw + seg).clamp(max=seg - 1))
    ws = torch.where(within, c - sub_in, c + prev_tot - sub_prev)
    return ws.reshape(vp.shape)[..., :n].to(v.dtype)


def sync_stats_plain(x: torch.Tensor):
    """(..., N) complex64 -> (a, p, c): a complex64, p and c float32."""
    zeros = x.new_zeros(x.shape[:-1] + (16,))
    xm16 = torch.cat([zeros, x], dim=-1)[..., : x.shape[-1]]
    m = x * torch.conj(xm16)
    a = _moving_sum(m, 48)
    p = _moving_sum(x.abs() ** 2, 64)
    c = a.abs() / torch.clamp(p, min=1e-12)
    return a, p, c


def sync_stats(x: torch.Tensor):
    """Dense (a, p, c) statistics for every sample: (..., N) complex64 ->
    a (..., N) complex64, p and c (..., N) float32.

    A CUDA tensor goes through the kernel (one launch for all rows); a CPU
    tensor through ``sync_stats_plain``."""
    if x.device.type == "cpu":
        return sync_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"sync_stats: unsupported device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"sync_stats: expected complex64, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"sync_stats: expected (..., N>0), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("sync_stats: input must be contiguous")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.numel() // n
    a = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    p = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    c = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if rows == 0:
        return a, p, c
    lib = build.library()
    err = lib.gwt_sync_stats(
        torch.view_as_real(x).data_ptr(), torch.view_as_real(a).data_ptr(),
        p.data_ptr(), c.data_ptr(), rows, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "sync_stats")
    sync_stats.launches += 1
    return a, p, c


sync_stats.launches = 0
