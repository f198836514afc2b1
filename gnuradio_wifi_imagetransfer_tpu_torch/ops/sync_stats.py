"""STF detector: CUDA kernel wrappers and their plain versions.

Replaces the JAX package's TPU kernel ops/pallas_sync.py (``_kernel``,
reached through ``_stats_1d``'s pl.pallas_call; wrapper ``sync_stats``)
and the detection around it (phy/sync.py ``detect``). The kernels are in
``csrc/sync_stats.cu``; both sum each window by additions only, so a
silent window is exactly 0 (see the source's note):

    sync_stats   dense a, p and c for every sample, one launch;
    sync_detect  the frame-start candidates of ``detect`` in two launches
                 (per tile: c, plateau, rising edges and the first K of
                 them; then a merge of the tiles a row), writing no dense
                 statistic to device memory.

``sync_stats_plain`` is the JAX package's XLA path (phy/sync.py:87-123) in
PyTorch: a delay-16 conjugate product and segmented moving sums.
``sync_detect_plain`` is the JAX package's ``detect`` over it, and
``first_edges_tiled`` a plain model of the detector's two-pass tiling.
``sync_stats_bound`` and ``sync_detect_bound`` are the kernels' bounds.
"""

from __future__ import annotations

import math

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build, roofline

DETECT_TILE = 992    # samples a detector block owns (csrc/sync_stats.cu kDetectTile)
MAX_PLATEAU = 32     # largest min_plateau sync_detect takes (kLookBack)


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
    build.count_launch(sync_stats, (x,))
    return a, p, c


sync_stats.launches = 0


def _delay(v: torch.Tensor, k: int) -> torch.Tensor:
    """v delayed by k samples along the last axis, False/0 shifted in."""
    return torch.cat([v.new_zeros(v.shape[:-1] + (k,)), v[..., : v.shape[-1] - k]], dim=-1)


def first_edges(edge: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k True entries along the last axis of a bool
    (..., N) mask, ascending; N where a row has fewer (torch.topk)."""
    n = edge.shape[-1]
    idx = torch.arange(n, device=edge.device)
    # first K edges == the K largest values of -index among edges; non-edges
    # hold the sentinel -n, the only value that can tie
    key = torch.where(edge, -idx, torch.full_like(idx, -n))
    return -torch.topk(key, k, dim=-1, sorted=True).values


def first_edges_tiled(edge: torch.Tensor, k: int, tile: int = DETECT_TILE) -> torch.Tensor:
    """``first_edges`` as the detector kernel computes it: each tile of
    ``tile`` samples keeps its first k edges, then the tiles are merged in
    order and the first k kept."""
    n = edge.shape[-1]
    lead = edge.shape[:-1]
    e = edge.reshape(-1, n)
    rows, tiles = e.shape[0], -(-n // tile)
    e = torch.cat([e, e.new_zeros(rows, tiles * tile - n)], dim=-1).reshape(rows, tiles, tile)
    rank = torch.cumsum(e.long(), dim=-1) - 1                 # rank inside the tile
    keep = e & (rank < k)                                     # the tile's first k
    cnt = keep.sum(dim=-1)                                    # (rows, tiles)
    grank = (torch.cumsum(cnt, dim=-1) - cnt)[..., None] + rank
    sel = keep & (grank < k)
    r_i, t_i, j_i = sel.nonzero(as_tuple=True)
    starts = torch.full((rows, k), n, dtype=torch.long, device=edge.device)
    starts[r_i, grank[sel]] = t_i * tile + j_i
    return starts.reshape(lead + (k,))


def detect_from_stats(a: torch.Tensor, c: torch.Tensor, max_frames: int, threshold: float,
                      min_plateau: int, search_lo: int = 0, search_hi: int | None = None):
    """The JAX package's ``detect`` (phy/sync.py:140-175) over given
    statistics: (starts, valid, cfo, ratio), each (..., max_frames)."""
    n = c.shape[-1]
    above = c >= threshold
    plateau = above                   # >= min_plateau consecutive samples ending at n
    for k in range(1, min_plateau):
        plateau = plateau & _delay(above, k)
    edge = plateau & ~_delay(plateau, 1)
    idx = torch.arange(n, device=c.device)
    if search_hi is None:
        search_hi = n
    edge = edge & (idx >= search_lo) & (idx < search_hi)
    starts = first_edges(edge, max_frames)
    valid = starts < n
    starts_c = torch.clamp(starts, max=n - 1)
    # the edge is the plateau END of the first min_plateau run; the trigger
    # sample (first above threshold) is min_plateau-1 earlier
    trigger = torch.clamp(starts_c - (min_plateau - 1), min=0)
    cfo = torch.angle(torch.gather(a, -1, trigger)) / 16.0
    return (torch.where(valid, trigger, 0).to(torch.int32), valid,
            torch.where(valid, cfo, 0.0).to(torch.float32),
            torch.gather(c, -1, trigger).to(torch.float32))


def sync_detect_plain(x: torch.Tensor, max_frames: int, threshold: float, min_plateau: int,
                      search_lo: int = 0, search_hi: int | None = None):
    """``detect_from_stats`` over ``sync_stats_plain``."""
    a, _, c = sync_stats_plain(x)
    return detect_from_stats(a, c, max_frames, threshold, min_plateau, search_lo, search_hi)


def sync_detect(x: torch.Tensor, max_frames: int, threshold: float, min_plateau: int,
                search_lo: int = 0, search_hi: int | None = None):
    """Frame-start candidates of (..., N) complex64 streams: (starts,
    valid, cfo, ratio), each (..., max_frames), the fields of
    ``phy.sync.FrameCandidates``. Edges are searched in [search_lo,
    search_hi); ``min_plateau`` is at most MAX_PLATEAU.

    A CUDA tensor goes through the detector kernels (two launches); a CPU
    tensor through ``sync_detect_plain``."""
    if x.device.type == "cpu":
        return sync_detect_plain(x, max_frames, threshold, min_plateau, search_lo, search_hi)
    if x.device.type != "cuda":
        raise ValueError(f"sync_detect: unsupported device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"sync_detect: expected complex64, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"sync_detect: expected (..., N>0), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("sync_detect: input must be contiguous")
    if not 1 <= min_plateau <= MAX_PLATEAU:
        raise ValueError(f"sync_detect: min_plateau {min_plateau} outside [1, {MAX_PLATEAU}]")
    if max_frames < 1:
        raise ValueError(f"sync_detect: max_frames {max_frames} < 1")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.numel() // n
    buf = _detect_buffer(rows, n, max_frames, x.device)
    if rows:
        _detect_launch(x, max_frames, threshold, min_plateau, search_lo, search_hi, buf)
        build.count_launch(sync_detect, (x, max_frames, threshold, min_plateau, search_lo,
                                         search_hi))
    starts, valid, a, ratio = _detect_outputs(buf, rows, max_frames)
    cfo = torch.where(valid, torch.angle(a) / 16.0, 0.0)
    return tuple(v.reshape(lead + (max_frames,)) for v in (starts, valid, cfo, ratio))


def _detect_buffer(rows: int, n: int, k: int, device) -> torch.Tensor:
    """One allocation for the detector's outputs and scratch: (rows, k)
    starts int32, ratio float32, a complex64 and valid bool, then the
    scratch at a 16-byte boundary."""
    out = -(-17 * rows * k // 16) * 16
    scratch = build.library().gwt_sync_detect_scratch_bytes(rows, n, k) if rows else 0
    return torch.empty(out + scratch, dtype=torch.uint8, device=device)


def _detect_outputs(buf: torch.Tensor, rows: int, k: int):
    m = rows * k
    return (buf[: 4 * m].view(torch.int32).view(rows, k),
            buf[16 * m: 17 * m].view(torch.bool).view(rows, k),
            buf[8 * m: 16 * m].view(torch.complex64).view(rows, k),
            buf[4 * m: 8 * m].view(torch.float32).view(rows, k))


def _detect_launch(x: torch.Tensor, k: int, threshold: float, min_plateau: int,
                   search_lo: int, search_hi: int | None, buf: torch.Tensor) -> None:
    """Both launches of the detector on (..., N) x into ``buf``."""
    n = x.shape[-1]
    rows = x.numel() // n
    lo = min(max(search_lo, 0), n)
    hi = n if search_hi is None else min(max(search_hi, 0), n)
    m = rows * k
    base = buf.data_ptr()
    err = build.library().gwt_sync_detect(
        torch.view_as_real(x).data_ptr(), rows, n, threshold, min_plateau, lo, hi, k,
        base + -(-17 * m // 16) * 16, base, base + 16 * m, base + 8 * m, base + 4 * m,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "sync_detect")


sync_detect.launches = 0


# Bounds (ms on the card, ``roofline``)
# ----------------------------------------------------------------------

# float32 operations per sample of the sync statistics in the kernels'
# addition-only form (csrc/sync_stats.cu, 8 outputs a thread): m (6),
# |x|^2 (3), the window sums of 8 outputs (the shared cores of 41 complex
# and 57 real terms 2 x 40 + 56, the suffix and running sums 2 x 3 x 7,
# 2 adds an output for each of the 3 sums 48: 226 for 8), |a| / p (5).
# None is a fused multiply-add, so they meet the instruction rate.
K1_OPS_PER_SAMPLE = 6 + 3 + 226 / 8 + 5
# the fused detector adds the threshold compare
K1_DETECT_OPS_PER_SAMPLE = K1_OPS_PER_SAMPLE + 1


def sync_stats_bound(x) -> dict:
    """Dense K1's bound on x (..., n) (anything with a ``shape``): each
    complex64 sample read once, its a (complex64), p and c (float32)
    written once; the statistics on every sample."""
    samples = math.prod(x.shape)
    return roofline.bound(samples * (8 + 16), samples * K1_OPS_PER_SAMPLE,
                          roofline.FP32_INSTR_PER_S)


def sync_detect_bound(x, k: int) -> dict:
    """The fused detector's bound on x (..., n) with k slots a row: each
    complex64 sample read once, each slot's start, valid, cfo and ratio
    written once; the statistics and the threshold compare on every
    sample."""
    samples = math.prod(x.shape)
    rows = samples // x.shape[-1]
    return roofline.bound(samples * 8 + rows * k * (4 + 1 + 8 + 4),
                          samples * K1_DETECT_OPS_PER_SAMPLE, roofline.FP32_INSTR_PER_S)
