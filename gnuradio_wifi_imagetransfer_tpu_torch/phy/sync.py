"""Frame synchronization front-end: dense STF autocorrelation detection,
coarse/fine CFO estimation and LTF matched-filter timing.

PyTorch port of the JAX package's phy/sync.py, batched over streams: every
function takes (..., N) or (B, N) where the JAX version takes one (N,)
stream and is vmapped. Statistic definitions (the GNU Radio graph):

    m[n] = x[n] * conj(x[n-16])
    a[n] = sum_{k=n-47..n} m[k]          (moving_average_cc(48))
    p[n] = sum_{k=n-63..n} |x[k]|^2      (moving_average_ff(64))
    c[n] = |a[n]| / p[n]

Trigger: c >= threshold for >= min_plateau consecutive samples (rising
edge); coarse CFO = arg(a[edge]) / 16 per sample, like sync_short. The
statistics come from ``ops.sync_stats`` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors).
"""

from __future__ import annotations

import dataclasses

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as _stats
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import param_table, resolve

# Windows are cut MARGIN samples before the detected edge; the edge lies
# inside the 160-sample STF, so preamble + frame always fit.
MARGIN = 160
LTF_SEARCH = MARGIN + params.PREAMBLE_LEN  # matched-filter search span


def window_len(n_sym: int) -> int:
    """Extraction window length for a frame of n_sym data symbols."""
    return MARGIN + params.PREAMBLE_LEN + (1 + n_sym) * params.N_SYM + 2 * params.N_SYM


@dataclasses.dataclass
class FrameCandidates:
    starts: torch.Tensor   # (..., K) int32 sample index of the detection trigger
    valid: torch.Tensor    # (..., K) bool
    cfo: torch.Tensor      # (..., K) float32 CFO (rad/sample)
    ratio: torch.Tensor    # (..., K) float32 c[n] at the trigger


def sync_stats(x: torch.Tensor):
    """Dense (a, p, c) statistics for every sample of (..., N) complex64."""
    return _stats.sync_stats(x)


def detect(
    x: torch.Tensor,
    max_frames: int,
    cfg: PhyConfig = PhyConfig(),
    search_lo: int = 0,
    search_hi: int | None = None,
) -> FrameCandidates:
    """Find up to ``max_frames`` frame-start candidates in each stream.

    x: (..., N) complex64. search_lo/search_hi bound the edge positions
    considered (the executor ignores its halos so each frame belongs to
    exactly one block). Returns (..., K) candidate fields, the first K
    rising edges of a plateau of ``cfg.min_plateau`` samples above
    ``cfg.sync_threshold``, from ``ops.sync_stats.sync_detect`` (the fused
    detector kernels for CUDA tensors, ``sync_detect_plain`` for CPU
    tensors).
    """
    starts, valid, cfo, ratio = _stats.sync_detect(
        x, max_frames, cfg.sync_threshold, cfg.min_plateau, search_lo, search_hi)
    return FrameCandidates(starts=starts, valid=valid, cfo=cfo, ratio=ratio)


def extract(x: torch.Tensor, starts: torch.Tensor, wlen: int) -> torch.Tensor:
    """Cut windows beginning MARGIN before each candidate edge.

    x: (..., N); starts: (..., K) -> (..., K, wlen). Each start is clamped
    to [0, N - wlen] like lax.dynamic_slice, so every window is whole.
    """
    n = x.shape[-1]
    s0 = torch.clamp(starts.long() - MARGIN, min=0, max=n - wlen)
    offs = s0[..., None] + torch.arange(wlen, device=x.device)        # (..., K, wlen)
    flat = torch.gather(x, -1, offs.reshape(offs.shape[:-2] + (-1,)))
    return flat.reshape(offs.shape)


def _ltf_locate(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Locate the second LTF body in each corrected window.

    w: (..., WL). Returns (q, score): q (...,) index of the second 64-sample
    LTF body; score (...,) the combined correlation magnitude.
    """
    t_span = LTF_SEARCH
    win = w[..., :t_span + 63].unfold(-1, 64, 1)                      # (..., T, 64)
    ltf = torch.conj(param_table("LTF_TIME", w.device))
    corr = torch.matmul(win, ltf).abs()                               # (..., T)
    score = corr[..., : t_span - 64] + corr[..., 64:]
    q1 = torch.argmax(score, dim=-1)                                  # first max
    best = torch.gather(score, -1, q1[..., None])[..., 0]
    return (q1 + 64).to(torch.int32), best


def fine_cfo(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Residual CFO from the two LTF repetitions 64 samples apart.

    w: (..., WL); q: (...,) second-body start. Returns (...,) rad/sample.
    """
    offs = q.long()[..., None] + torch.arange(64, device=w.device)
    b2 = torch.gather(w, -1, offs)
    b1 = torch.gather(w, -1, offs - 64)
    return (torch.angle((b2 * torch.conj(b1)).sum(dim=-1)) / 64.0).to(torch.float32)


def _derotate(w: torch.Tensor, cfo: torch.Tensor) -> torch.Tensor:
    """w[..., n] * exp(-j cfo n) for windows (..., WL), cfo (...,)."""
    n_idx = torch.arange(w.shape[-1], device=w.device)
    phase = -(cfo[..., None] * n_idx)
    return w * torch.polar(torch.ones_like(phase), phase)


def synchronize(
    x: torch.Tensor,
    n_sym: int,
    max_frames: int,
    cfg: PhyConfig = PhyConfig(),
    search_lo: int = 0,
    search_hi: int | None = None,
):
    """Full front-end: detect, extract, CFO-correct, time-align.

    x: (..., N) complex64 raw streams.
    Returns (windows, frame_start, cand): windows (..., K, WL) CFO-corrected
    samples, frame_start (..., K) index of the preamble start within each
    window (feed to rx.decode_aligned) and the FrameCandidates.
    """
    wlen = window_len(n_sym)
    if x.shape[-1] < wlen:
        raise ValueError(
            f"stream of {x.shape[-1]} samples is shorter than one frame "
            f"extraction window ({wlen}); pad the block or use a larger "
            f"ExecutorConfig.block_size")
    cand = detect(x, max_frames, cfg, search_lo, search_hi)
    w1 = _derotate(extract(x, cand.starts, wlen), cand.cfo)          # (..., K, WL)
    q, _ = _ltf_locate(w1)
    eps = fine_cfo(w1, q)
    w2 = _derotate(w1, eps)
    frame_start = q - params.LTF2_OFFSET                              # preamble start
    # guard: a bogus peak location would index out of range
    max_start = wlen - (params.PREAMBLE_LEN + (1 + n_sym) * params.N_SYM + params.N_CP)
    ok = (frame_start >= 0) & (frame_start <= max_start)
    cand = FrameCandidates(
        starts=cand.starts,
        valid=cand.valid & ok,
        cfo=(cand.cfo + eps).to(torch.float32),
        ratio=cand.ratio,
    )
    return w2, torch.clamp(frame_start, 0, max_start).to(torch.int32), cand


def receive(x, plan, max_frames: int, cfg: PhyConfig = PhyConfig(), algo=None,
            device="cuda"):
    """Raw stream -> decoded frames (fixed MCS/length plan).

    x: (..., N) complex samples (numpy or tensor), moved to ``device``.
    Returns (RxResult, cand); invalid candidate slots carry garbage bytes
    (mask with cand.valid).
    """
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx as rxmod

    dev = resolve(device)
    x = torch.as_tensor(x, device=dev).to(torch.complex64)
    if algo is None:
        algo = ChannelEstimator(cfg.chan_est)
    windows, frame_start, cand = synchronize(x, plan.n_sym, max_frames, cfg)
    res = rxmod.decode_aligned(windows, plan, start=frame_start, algo=algo)
    return res, cand
