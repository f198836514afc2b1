"""Sample-rate-conversion front-end for the streaming executor (the port's
copy of the JAX package's parallel/frontend.py).

An input stream captured at ``nominal * M/L * (1 + ppm*1e-6)`` is
corrected to the nominal grid on the device before sync. The exact
combined ratio (a ``fractions.Fraction``) is factored into a chain of up
to two stages:

  decimation   integer M >= 2: anti-alias FIR + keep-every-Mth, as K
               strided slices and scaled adds over the stream
               (y[j] = sum_t h[t] x[jM + a - t]), in plain torch ops.
  clock trim   |ratio - 1| <= 2.5e-3 (ppm-scale): windowed-sinc
               fractional-delay interpolation per SUB-BLOCK (default 512
               samples) with a constant delay per sub-block; the timing
               ripple is sub_block * |delta| / 2 (0.01 samples at 40 ppm).
               Integer drift is absorbed by per-sub-block window starts
               computed with EXACT host integer arithmetic (float32 cannot
               address sample 1e8 to 1e-5 precision), so only small
               relative offsets reach the device.

Other small rationals (e.g. 3/4) fall back to ops/resampler.py's
polyphase resampler (the CUDA kernel K4 on the card) as one whole-stream
pass, local executor mode only.

The local executor ships the input-rate stream once and keeps the
corrected output-rate stream resident on the device (``padded_geometry``
and ``correct_padded``). ``block_ext_in``, ``block_cut`` and
``correct_block`` give the per-window geometry and correction that the
mesh and adaptive executors use.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import FrontendConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import resampler

# trim regime bound: |in_per_out - 1| <= 1/400 (2500 ppm)
_TRIM_MAX = Fraction(1, 400)
_MAX_DECIM = 32


def combined_in_per_out(cfg: FrontendConfig) -> Fraction:
    """Exact input samples consumed per output sample.

    resample=(L, M): the input rate is nominal * M/L. ppm: the input clock
    additionally ran (1 + ppm*1e-6) fast (the convention of the JAX
    package's channel.model.sample_clock_offset, which this front-end
    inverts)."""
    l, m = cfg.resample
    if l < 1 or m < 1:
        raise ValueError(f"resample ratio terms must be >= 1, got {(l, m)}")
    r = Fraction(m, l)
    if cfg.ppm:
        r = r / (1 + Fraction(cfg.ppm) / 10**6)
    return r


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------


class _DecimStage:
    """Integer-M anti-alias decimation as K strided slices."""

    def __init__(self, m: int, taps_per_phase: int):
        import scipy.signal as sig

        self.m = m
        # odd length: a type-I symmetric FIR with an INTEGER group delay
        self.k = m * taps_per_phase + 1
        self.center = (self.k - 1) // 2
        # passband gain 1, cutoff at the OUTPUT Nyquist
        self.taps = sig.firwin(self.k, 1.0 / m, window=("kaiser", 7.0)).astype(np.float32)
        self.in_per_out = Fraction(m)

    def apply(self, x: torch.Tensor, n_out: int, a: int) -> torch.Tensor:
        """y[..., j] = sum_t h[t] * x[..., j*m + a - t], j in [0, n_out).
        Requires a >= k-1 and x.shape[-1] >= (n_out-1)*m + a + 1."""
        assert a >= self.k - 1
        span = (n_out - 1) * self.m + 1
        acc = None
        for t, h in enumerate(self.taps.tolist()):     # tap order of the JAX stage
            sl = x[..., a - t: a - t + span: self.m]
            acc = h * sl if acc is None else acc.add_(h * sl)
        return acc


class _TrimStage:
    """ppm-scale resampling by per-sub-block fractional delay."""

    def __init__(self, in_per_out: Fraction, frac_taps: int, sub: int):
        self.r = in_per_out
        self.delta = float(in_per_out - 1)       # |delta| <= 2.5e-3
        self.k = frac_taps
        self.center = (self.k - 1) // 2
        self.sub = sub
        self.in_per_out = in_per_out

    def _taps(self, taus: torch.Tensor) -> torch.Tensor:
        """(B,) fractional delays in [0, 1) -> (B, K) Hann-windowed-sinc
        interpolation taps for y = x(i + tau): c_t = wsinc(t - c - tau)."""
        arg = (torch.arange(self.k, dtype=torch.float32, device=taus.device)[None, :]
               - self.center - taus[:, None])
        w = torch.clamp(0.5 + 0.5 * torch.cos(math.pi * arg / (self.center + 1)), min=0.0)
        h = torch.sinc(arg) * w
        return h / h.sum(dim=-1, keepdim=True)

    def apply(self, x: torch.Tensor, sub_starts: torch.Tensor,
              taus: torch.Tensor, n_out: int) -> torch.Tensor:
        """x: (..., N); sub_starts: (B,) window origin of each sub-block
        (output i of sub-block b reads x[start_b + i .. start_b + i + K));
        taus: (B,) float32 fractional delay per sub-block. Returns
        (..., n_out). Starts are clamped into the stream as the JAX
        package's dynamic slices clamp them."""
        width = self.sub + self.k
        starts = sub_starts.to(torch.int64).clamp(0, max(x.shape[-1] - width, 0))
        idx = starts[:, None] + torch.arange(width, device=x.device)[None, :]
        w = x[..., idx]                                  # (..., B, sub+K)
        h = self._taps(taus)                             # (B, K)
        acc = None
        for t in range(self.k):
            term = h[:, t, None] * w[..., t: t + self.sub]
            acc = term if acc is None else acc.add_(term)
        return acc.reshape(acc.shape[:-2] + (-1,))[..., :n_out]


# ----------------------------------------------------------------------
# the front-end
# ----------------------------------------------------------------------


class Frontend:
    """Factored rate-conversion chain + executor geometry helpers."""

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        self.ratio = combined_in_per_out(cfg)     # input per output, exact
        self.decim: _DecimStage | None = None
        self.trim: _TrimStage | None = None
        self.general: Fraction | None = None
        r = self.ratio
        if r == 1:
            return
        m0 = (r.numerator + r.denominator // 2) // r.denominator  # round(r)
        if 2 <= m0 <= _MAX_DECIM and abs(r / m0 - 1) <= _TRIM_MAX:
            self.decim = _DecimStage(m0, cfg.taps_per_phase)
            resid = r / m0
            if resid != 1:
                self.trim = _TrimStage(resid, cfg.frac_taps, cfg.sub_block)
        elif abs(r - 1) <= _TRIM_MAX:
            self.trim = _TrimStage(r, cfg.frac_taps, cfg.sub_block)
        else:
            self.general = r                      # ops/resampler fallback

    @property
    def active(self) -> bool:
        return self.ratio != 1

    def out_len(self, n_in: int) -> int:
        """Number of complete output-grid samples in an n_in-sample input."""
        return int(n_in / self.ratio)

    # exact mid-rate position chain: out global s -> mid position (after
    # decim, before trim); mid == in when no decim, mid == out when no trim
    def _mid_pos(self, s) -> Fraction:
        return Fraction(s) * (self.trim.r if self.trim else 1)

    # -- local (resident whole-stream) path ----------------------------

    def _local_mid_geom(self, np_out: int, p_out: int) -> tuple[int, int]:
        """(p_mid, n_mid): the intermediate (post-decim, pre-trim) padded
        stream's left pad and total length. The last trim sub-block's
        window (sub + K samples past its start) must fit."""
        tr = self.trim
        if tr is None:
            return p_out, np_out
        p_mid = int(math.ceil(p_out * float(tr.r))) + tr.center + 4
        n_mid = (int(math.ceil((np_out - p_out) * float(tr.r)))
                 + p_mid + tr.sub + tr.k + 8)
        return p_mid, n_mid

    def padded_geometry(self, np_out: int, p_out: int):
        """Host-exact geometry for the whole-padded-stream correction.

        np_out: padded output length; p_out: output left pad (padded output
        index p holds out global sample p - p_out). Returns (p_in,
        n_in_pad, aux): the input's left pad and padded length, and the
        operands of ``correct_padded`` (for a trim stage the (B,) int32
        sub-block starts and float32 delays, as CPU tensors)."""
        if self.general is not None:
            return self._general_geometry(np_out, p_out)
        p_mid, n_mid = self._local_mid_geom(np_out, p_out)
        if self.trim is not None:
            tr = self.trim
            n_sub = -(-np_out // tr.sub)
            sub_starts = np.empty(n_sub, np.int32)
            taus = np.empty(n_sub, np.float32)
            half = Fraction(tr.sub, 2) * (tr.r - 1)
            for b in range(n_sub):
                p = self._mid_pos(b * tr.sub - p_out)       # exact
                base = math.floor(p)
                sub_starts[b] = base - tr.center + p_mid
                taus[b] = float(p - base + half)  # delay at sub-block middle
            assert sub_starts.min() >= 0
            assert sub_starts.max() + tr.sub + tr.k <= n_mid
            aux = (torch.from_numpy(sub_starts), torch.from_numpy(taus))
        else:
            aux = ()
        if self.decim is not None:
            de = self.decim
            p_in = p_mid * de.m + de.k
            n_in_pad = n_mid * de.m + 2 * de.k
        else:
            p_in, n_in_pad = p_mid, n_mid
        return p_in, n_in_pad, aux

    def correct_padded(self, x: torch.Tensor, np_out: int, p_out: int,
                       aux) -> torch.Tensor:
        """(..., n_in_pad) complex input-rate padded stream -> (..., np_out)
        corrected output-rate padded stream, on x's device."""
        if self.general is not None:
            return self._general_apply(x, np_out, p_out)
        _, n_mid = self._local_mid_geom(np_out, p_out)
        mid = x
        if self.decim is not None:
            mid = self.decim.apply(x, n_mid, self.decim.k + self.decim.center)
        if self.trim is not None:
            sub_starts, taus = (a.to(x.device) for a in aux)
            mid = self.trim.apply(mid, sub_starts, taus, np_out)
        return mid

    # general-rational fallback: one ops/resampler pass, local mode only
    _GEN_MARGIN = 16

    def _general_geometry(self, np_out: int, p_out: int):
        r = self.general
        m, l = r.numerator, r.denominator
        p_in = m * (p_out + self._GEN_MARGIN)
        s0 = p_out * (l - 1) + l * self._GEN_MARGIN
        n_in_pad = int(math.ceil((s0 + np_out) * r)) + self._GEN_MARGIN * m
        return p_in, n_in_pad, ()

    def _general_apply(self, x, np_out, p_out):
        r = self.general
        m, l = r.numerator, r.denominator
        s0 = p_out * (l - 1) + l * self._GEN_MARGIN
        y = resampler.rational_resampler(x, l, m)
        return y[..., s0: s0 + np_out]

    # -- mesh (per-shard extended block) path --------------------------

    def _trim_guards(self, ext_out: int) -> tuple[int, int]:
        d = self.trim.delta if self.trim else 0.0
        left = int(math.ceil(ext_out * max(-d, 0.0))) + 4
        right = int(math.ceil(ext_out * max(d, 0.0))) + 4
        return left, right

    def block_ext_in(self, ext_out: int) -> int:
        """Input-window length a shard needs to produce ext_out corrected
        samples (filter tails + clock-drift guards included)."""
        if self.general is not None:
            raise ValueError(
                "mesh-mode executors support decimation/clock-trim "
                "front-ends; general rational ratios run in local mode")
        ext_mid = ext_out
        if self.trim is not None:
            lg, rg = self._trim_guards(ext_out)
            ext_mid = ext_out + lg + rg + self.trim.k + self.trim.sub
        if self.decim is not None:
            de = self.decim
            return (ext_mid - 1) * de.m + de.k + de.center + 1
        return ext_mid

    def block_cut(self, s0: int, ext_out: int) -> tuple[int, float]:
        """Host-exact cut parameters for a window producing ext_out
        corrected samples from out-global sample s0: returns (in_cut, tau0),
        the absolute input index to cut block_ext_in(ext_out) samples from
        and the fractional phase scalar the correction needs."""
        if self.trim is not None:
            lg, _ = self._trim_guards(ext_out)
            p = self._mid_pos(s0)
            mid0 = math.floor(p) - self.trim.center - lg
            tau0 = float(p - mid0)
        else:
            mid0, tau0 = s0, 0.0
        if self.decim is not None:
            return mid0 * self.decim.m - self.decim.k, tau0
        return mid0, tau0

    def correct_block(self, x: torch.Tensor, tau0, ext_out: int) -> torch.Tensor:
        """(..., block_ext_in(ext_out)) raw cut + tau0 scalar -> (...,
        ext_out) corrected samples. Stateless: the guards follow from
        ext_out, so one cached Frontend serves every window size."""
        mid = x
        if self.decim is not None:
            de = self.decim
            ext_mid = (x.shape[-1] - de.k - de.center) // de.m + 1
            mid = de.apply(x, ext_mid, de.k + de.center)
        if self.trim is not None:
            tr = self.trim
            n_sub = -(-ext_out // tr.sub)
            tau0 = torch.as_tensor(tau0, dtype=torch.float32, device=x.device)
            blk = torch.arange(n_sub, device=x.device)
            q = tau0 + blk.to(torch.float32) * tr.sub * tr.delta     # drift, |q| small
            qf = torch.floor(q)
            sub_starts = (blk * tr.sub).to(torch.int32) + qf.to(torch.int32) - tr.center
            taus = q - qf + (tr.sub / 2) * tr.delta                  # delay at middle
            mid = tr.apply(mid, sub_starts, taus, ext_out)
        return mid


@functools.lru_cache(maxsize=16)
def cached_frontend(cfg: FrontendConfig) -> Frontend | None:
    """One Frontend per config (tap design + Fraction factoring cached);
    None when the combined ratio is exactly 1."""
    fe = Frontend(cfg)
    return fe if fe.active else None
