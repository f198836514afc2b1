"""The ITS-G5 receiver cell: ``AdaptiveStreamExecutor.run`` with the STA
tracker over four-channel 802.11p streams through a vehicular fading
channel (yardstick/vehicular.py), in a closed loop.

It is the receiver cell of ``harness.rx`` with three changes. Set-up makes
the fading streams. The check holds each run's records to the stream's
truth and to the plain STA receiver (yardstick/track_rx.py) rather than
to the truth alone: under fading a tracker loses some frames whatever its
precision, so a truth frame that the port does not deliver counts as
failed only where the plain receiver decodes it both from the stream as
sent and with the stream's noise raised by 1 dB; where it does not, the
frame is marginal (``frames_marginal``), reported and not compared. The
per-frame SNR is held to the plain receiver's decision-directed EVM SNR
(the estimator the port reports) on frames drawn from the seed. And the
traced run adds the tracker's work: the executor's ``track`` counter and
the symbol-steps of the profiled runs for K5's roofline.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from harness import common, rx
from yardstick import reference, track_rx, vehicular, vtx

NOISE_UP_DB = 1.0
WIRE_SCALE = {"sc16": (4.0, 32767.0), "sc8": (2.0, 127.0)}   # utils/xfer.py's full scales


def wire_samples(x: np.ndarray, wire: str) -> np.ndarray:
    """x as the wire format carries it (each axis scaled to its integer
    range, rounded half to even, clipped, scaled back), complex128: what
    the receiver is given."""
    if wire == "f32":
        return x.astype(np.complex128)
    full, top = WIRE_SCALE[wire]
    k = top / full

    def axis(v):
        return np.clip(np.round(v.astype(np.float64) * k), -top - 1, top) / k

    return axis(x.real) + 1j * axis(x.imag)


class Cell(rx.Cell):
    def __init__(self, work, config, traffic, seed, rehearse, overrides=None, cpus=None):
        super().__init__(work, config, traffic, seed, rehearse, overrides=overrides, cpus=cpus)
        # the configuration's own wire format, whatever an override runs
        self.wire = config["executor"]["wire_format"]

    def setup(self) -> None:
        import torch

        from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, PhyConfig
        from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import AdaptiveStreamExecutor
        from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import Tracer

        t0 = time.perf_counter()
        ex_cfg = ExecutorConfig(**self.conf["executor"])
        self.channels = ex_cfg.channels
        self.block = ex_cfg.block_size
        self.n = ex_cfg.time_shards * ex_cfg.block_size
        self.device = torch.device("cpu" if self.rehearse else "cuda")
        self.ex = AdaptiveStreamExecutor(exec_cfg=ex_cfg, phy_cfg=PhyConfig(**self.conf["phy"]),
                                         tracer=Tracer(), device=self.device)
        t1 = time.perf_counter()
        self.pool, self.streams = vehicular.make_streams(self.traffic, self.channels, self.n,
                                                         self.block, self.seed)
        t2 = time.perf_counter()
        if self.cpus:
            common.pin(self.cpus["drive"])           # this thread drives the card
        for s in self.streams:                       # every graph key of the window
            self.ex.run(s.x)
        self.ex.run(self.streams[0].x)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"program_s": t1 - t0, "traffic_s": t2 - t1,
                            "warm_s": time.perf_counter() - t2}

    def window(self, seconds: float, trace: bool, slice_cls=None) -> None:
        super().window(seconds, trace, slice_cls)
        track = self.ex.tracer.report().get("track")    # absent where no tracker counts
        self.track_steps = None if track is None else track.samples / len(self.runs)

    def layer_context(self, reduce) -> dict:
        ctx = super().layer_context(reduce)
        ctx["track_steps"] = self.track_steps
        p = ctx.get("profile")
        if p:
            rows = steps = 0
            for i in rx.PROFILED_RUNS:
                s = self.streams[self.runs[i][0]]
                ns = np.array([vtx.n_sym(int(m), int(ln)) for m, ln in zip(s.mcs, s.length)])
                rows += 2 * s.frames               # stage A's SIGNAL, stage B's frame
                steps += int((2 + ns).sum())
            p["work"].update(track_rows=rows, track_steps=steps)
        return ctx

    # -- the check -----------------------------------------------------------

    def _segments(self, frames: list, noise_up: bool):
        """(F, W) complex128 windows from track_rx.SEARCH samples before the
        first preamble sample of each of [(stream, truth index)] of one
        rate and length, as the configuration's wire format carries them,
        on the cell's device (the plain receiver runs there once the
        program's state is freed); with ``noise_up`` the stream's noise
        raised by NOISE_UP_DB."""
        import torch

        k0, i0 = frames[0]
        s0 = self.streams[k0]
        w = vtx.burst_len(int(s0.mcs[i0]), int(s0.length[i0])) + 2 * track_rx.SEARCH + 16
        xs = np.empty((len(frames), w), np.complex64)
        for r, (k, i) in enumerate(frames):
            s = self.streams[k]
            a = s.start[i] - track_rx.SEARCH
            xs[r] = s.x[s.channel[i], a: a + w]
            if noise_up:
                rng = np.random.default_rng(np.random.SeedSequence([int(self.seed), 0x1DB, k, i]))
                sd = s.noise_sigma * np.sqrt(10.0 ** (NOISE_UP_DB / 10.0) - 1.0)
                more = (rng.standard_normal((w, 2)) * sd).astype(np.float32)
                xs[r] += more.view(np.complex64)[:, 0]
        return torch.from_numpy(wire_samples(xs, self.wire)).to(self.device)

    def _reference_decodes(self, frames: set) -> dict:
        """{(stream, truth index): whether the plain receiver decodes the
        frame (SIGNAL's rate, length and parity, and the PSDU) both as sent
        and with the noise raised}."""
        by_key: dict = {}
        for k, i in sorted(frames):
            s = self.streams[k]
            by_key.setdefault((int(s.mcs[i]), int(s.length[i])), []).append((k, i))
        out = {}
        for (mcs, length), fr in by_key.items():
            for up in (False, True):             # the raised noise only where the first passed
                want = [self.streams[k].psdu(self.pool, i) for k, i in fr]
                res = track_rx.receive(self._segments(fr, up), mcs, length, "STA", **self.gains)
                ok = track_rx.delivered(res, mcs, want)
                out.update((f, False) for f, good in zip(fr, ok) if not good)
                fr = [f for f, good in zip(fr, ok) if good]
                if not fr:
                    break
            out.update((f, True) for f in fr)
        return out

    @property
    def gains(self) -> dict:
        phy = self.conf["phy"]
        return {"mu": phy.get("lms_mu", track_rx.MU), "alpha": phy.get("sta_alpha", track_rx.ALPHA),
                "beta": phy.get("sta_beta", track_rx.BETA)}

    def _describe(self, k: int, i: int) -> dict:
        """A failed truth frame and the records of the last run of its
        stream that start inside its preamble, for the result's info."""
        s = self.streams[k]
        recs = next(recs for kk, recs in reversed(self.runs) if kk == k)
        near = [(r.rate_idx, r.length, bool(r.parity_ok), int(r.global_start - s.start[i]))
                for r in recs if r.channel == s.channel[i]
                and -400 <= r.global_start - s.start[i] < 400]
        return {"stream": k, "frame": i, "mcs": int(s.mcs[i]), "length": int(s.length[i]),
                "records": near}

    def check(self) -> tuple[int, int, dict]:
        """(attempted, failed, checks) over every run of the window: a truth
        frame not delivered fails where the plain receiver decodes it with
        the noise margin, and is marginal where it does not; the SNR on a
        sample of the delivered frames drawn from the seed. A run whose
        records are those of an earlier run of its stream, field for field
        and byte for byte, takes that run's verdict."""
        t0 = time.perf_counter()
        attempted = spurious = 0
        cfo_err = 0.0
        matched, missed, arrays = [], [], []
        verdicts: dict = {}          # a run whose records equal an earlier run's of its stream
        for r, (k, recs) in enumerate(self.runs):
            a = reference.records_arrays(recs)
            arrays.append(a)
            digest = (k, hashlib.sha1(b"".join(
                [a[f].tobytes() for f in ("channel", "start", "ok", "mcs", "length", "cfo", "snr")]
                + [p.tobytes() for p in a["psdu"]])).digest())
            res = verdicts.get(digest)
            if res is None:
                res = verdicts[digest] = reference.check_stream(self.streams[k], self.pool, a)
            attempted += res["frames"]
            spurious += res["spurious"]
            missed += [(k, i) for i in res["bad"]]
            s = self.streams[k]
            for i, j in res["matched"].items():
                cfo_err = max(cfo_err, abs(a["cfo"][j] - s.cfo[i]))
                matched.append((r, i, j))
        decodes = self._reference_decodes(set(missed))
        failed = sum(decodes[m] for m in missed)
        lost = sorted({m for m in missed if decodes[m]})
        marginal = len(missed) - failed
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed), 0x5A]))
        pick = rng.permutation(len(matched))[: int(self.conf["snr_sample"])]
        by_key: dict = {}
        for m in pick:
            r, i, j = matched[m]
            s = self.streams[self.runs[r][0]]
            by_key.setdefault((int(s.mcs[i]), int(s.length[i])), []).append((r, i, j))
        gaps, who = [], []
        for (mcs, length), fr in by_key.items():
            xs = self._segments([(self.runs[r][0], i) for r, i, _ in fr], False)
            eq, _, _ = track_rx.equalized(xs, mcs, length, "STA", **self.gains)
            ref = track_rx.evm_snr_db(eq[:, 1:], mcs)
            gaps += [arrays[r]["snr"][j] - ref[q] for q, (r, i, j) in enumerate(fr)]
            who += [(self.runs[r][0], i, float(arrays[r]["snr"][j]), float(ref[q]))
                    for q, (r, i, j) in enumerate(fr)]
        worst = [who[q] for q in np.argsort(-np.abs(gaps))[:4]]
        gaps = np.array(gaps) if gaps else np.array([np.inf])
        checks = {"frames_bad": failed,
                  "snr_gap_max_db": float(np.max(np.abs(gaps))),
                  "snr_bias_db": float(abs(np.mean(gaps)))}
        self.info = {"frames_marginal": marginal, "frames_missed_unique": len(set(missed)),
                     "failed_frames": [self._describe(k, i) for k, i in lost[:8]],
                     "delivered_share": float(len(matched) / max(attempted, 1)),
                     "spurious_records": spurious, "snr_compared": int(len(pick)),
                     "snr_gap_mean_db": float(np.mean(gaps)),
                     "snr_gap_worst": worst,
                     "cfo_err_max": float(cfo_err),
                     "runs": len(self.runs), "setup_parts": self.setup_parts,
                     "check_s": time.perf_counter() - t0, "distinct_runs": len(verdicts),
                     "run_ms_min_median_max": [1e3 * float(np.min(self.run_s)),
                                               1e3 * float(np.median(self.run_s)),
                                               1e3 * float(np.max(self.run_s))]}
        return attempted, failed, checks
