"""Adaptive-MCS receiver: SIGNAL-steered per-frame decode of one buffer.

PyTorch port of the JAX package's parallel/adaptive.py. The reference
receiver never knows the MCS in advance: it decodes the SIGNAL field of
each detected frame (rate + length) and decodes the payload with those
parameters. Reception is split in two stages around a host dispatch:

  stage A: sync over the whole buffer with windows long enough for the
    largest allowed PSDU at the slowest rate, then a SIGNAL-only decode of
    every candidate;
  host dispatch: bucket valid candidates by decoded (rate_idx, length);
  stage B: the full decode of each bucket, from the stage-A windows,
    which stay on the device.

This is the simple single-buffer form; ``parallel.executor.
AdaptiveStreamExecutor`` is the streaming one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params, rx, sync
from gnuradio_wifi_imagetransfer_tpu_torch.phy.tx import TxPlan
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


@dataclasses.dataclass
class AdaptiveFrame:
    """One frame decoded with runtime-detected parameters."""

    start: int              # sync-edge sample index in the input stream
    rate_idx: int           # decoded MCS 0..7
    length: int             # decoded PSDU byte count
    psdu: np.ndarray        # (length,) uint8
    sig_ok: bool            # SIGNAL parity + tail check
    cfo: float


class AdaptiveReceiver:
    """Receive frames of unknown MCS/length from a raw sample stream, on
    ``device`` ("cuda" unless the caller passes "cpu")."""

    def __init__(self, max_psdu: int = 800, max_frames: int = 8,
                 phy_cfg: PhyConfig = PhyConfig(),
                 algo: ChannelEstimator = ChannelEstimator.LS,
                 device="cuda"):
        self.max_psdu = max_psdu
        self.max_frames = max_frames
        self.phy = phy_cfg
        self.algo = algo
        self.device = resolve(device)
        # worst case: largest PSDU at the slowest rate (MCS 0)
        self.n_sym_max = params.n_symbols(0, max_psdu)
        self.wlen = sync.window_len(self.n_sym_max)

    def _stage_a(self, x: torch.Tensor):
        """(N,) complex64 -> (windows, frame_start, candidates, SIGNAL dict)."""
        windows, frame_start, cand = sync.synchronize(
            x, self.n_sym_max, self.max_frames, self.phy)
        # SIGNAL-only decode from the spectra of the first two symbols
        sig = rx.decode_signal(windows, frame_start, self.algo, n_sym=1)
        return windows, frame_start, cand, sig

    def receive(self, x) -> list[AdaptiveFrame]:
        """x: (N,) complex raw samples -> decoded frames, SIGNAL-steered.

        A stream shorter than the worst-case extraction window (window_len
        of the configured max_psdu) is zero-padded to it.
        """
        x = np.asarray(x, dtype=np.complex64)
        if x.size < self.wlen:
            x = np.pad(x, (0, self.wlen - x.size))
        windows, frame_start, cand, sig = self._stage_a(torch.from_numpy(x).to(self.device))
        valid, starts, cfo, rate_idx, length, sig_ok = (
            v.cpu().numpy() for v in (cand.valid, cand.starts, cand.cfo, sig["rate_idx"],
                                      sig["length"], sig["parity_ok"]))

        # bucket candidate slots by decoded (mcs, length) for batched stage B
        ok = np.flatnonzero(valid & rx.steerable(sig_ok, rate_idx, length, self.max_psdu))
        frames: list[AdaptiveFrame] = []
        for (mcs, ln), pos in rx.signal_buckets(rate_idx[ok], length[ok]).items():
            slots = ok[pos]
            sel = torch.as_tensor(slots, device=self.device)
            res = rx.decode_aligned(windows[sel], TxPlan(mcs, ln), start=frame_start[sel],
                                    algo=self.algo)
            psdu = res.psdu.cpu().numpy()
            for i, k in enumerate(slots):
                frames.append(AdaptiveFrame(
                    start=int(starts[k]), rate_idx=mcs, length=ln,
                    psdu=psdu[i], sig_ok=True, cfo=float(cfo[k])))
        frames.sort(key=lambda f: f.start)
        return frames
