"""The receiver cells: ``AdaptiveStreamExecutor.run`` over seeded
multi-channel streams, in a closed loop.

Set-up makes the traffic's streams (yardstick/streams.py) and warms the
executor with one ``run`` of each, which captures every CUDA graph the
window replays (the step and each stage-B bucket). The window calls
``run`` back to back over the streams until ``seconds`` have passed; the
rate is all the samples of the completed runs over the window's time.
After the window every run's records are held to their stream's truth.

With ``trace``, two whole runs early in the window are profiled, and the
executor's host layers are marked by ``bench.*`` ranges wrapped around
its bound methods on this object (no program file is touched).
"""

from __future__ import annotations

import functools
import gc
import time

import numpy as np

from harness import common
from yardstick import reference, streams, vtx

PROFILED_RUNS = (2, 3)           # the window's runs the traced slice covers
SPANS = ("run", "_pad_wire", "_collect_candidates", "_stage_b_dispatch", "_drain")


def _wrap(obj, name: str, fn_factory) -> None:
    setattr(obj, name, fn_factory(getattr(obj, name)))


class Cell:
    def __init__(self, work: dict, config: dict, traffic: dict, seed: int, rehearse: bool,
                 overrides: dict | None = None, cpus: dict | None = None):
        self.work, self.conf, self.traffic = work, dict(config), dict(traffic)
        if rehearse:
            self.conf = {**self.conf, **self.conf.get("rehearse", {})}
            self.traffic = {**self.traffic, **self.traffic.get("rehearse", {})}
        if overrides:
            self.conf["executor"] = {**self.conf["executor"], **overrides}
        self.seed, self.rehearse, self.cpus = seed, rehearse, cpus
        self.runs: list = []
        self.run_s: list = []
        self.traced = False

    # -- set-up ----------------------------------------------------------

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
        self.pool, self.streams = streams.make_streams(self.traffic, self.channels, self.n,
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

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, trace: bool, slice_cls=None) -> None:
        from torch.profiler import record_function

        if trace:
            for name in SPANS:
                _wrap(self.ex, name, lambda f, n=name: _ranged(f"bench.{n.lstrip('_')}", f))
        self.ex.tracer.reset()
        cap0 = self.ex.graphs.captured
        prof = None
        t0 = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.streams)
            if trace and i == PROFILED_RUNS[0]:
                prof = slice_cls()
                prof.start()
                rng = record_function("bench.slice")
                rng.__enter__()
            t = time.perf_counter()
            recs = self.ex.run(self.streams[k].x)
            self.run_s.append(time.perf_counter() - t)
            if prof is not None and i == PROFILED_RUNS[-1]:
                rng.__exit__(None, None, None)
                prof.stop()
                self.prof = prof
            self.runs.append((k, recs))
            gc.freeze()       # the kept records are the harness's: the collector skips them
            i += 1
            if time.perf_counter() - t0 >= seconds and (not trace or i > PROFILED_RUNS[-1]):
                break
        self.elapsed = time.perf_counter() - t0
        self.captures = self.ex.graphs.captured - cap0
        self.stages = {k: v.seconds for k, v in self.ex.tracer.report().items()}
        self.traced = prof is not None

    def after_window(self) -> None:
        """The window's records are all the check needs."""

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.ex = None
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    # -- results -----------------------------------------------------------

    def end_to_end(self) -> dict:
        samples = len(self.runs) * self.channels * self.n
        return {"rx_msamples_per_s": samples / self.elapsed / 1e6}

    def layer_context(self, reduce) -> dict:
        ctx = {"runs": len(self.runs), "stages": self.stages, "captures": self.captures,
               "profile": None}
        if self.traced:
            p = reduce(self.prof.events())
            work = {"k1_samples": 0, "k1_rows": 0, "k1_slots": 0, "k2_steps": 0}
            for i in PROFILED_RUNS:
                s = self.streams[self.runs[i][0]]
                work["k1_samples"] += self.channels * self.n
                work["k1_rows"] += self.channels * self.conf["executor"]["time_shards"]
                work["k1_slots"] = self.conf["executor"]["max_frames_per_block"]
                work["k2_steps"] += int(sum(24 + vtx.trellis_steps(int(ln)) for ln in s.length))
            p["work"] = work
            ctx["profile"] = p
        return ctx

    def check(self) -> tuple[int, int, dict]:
        """(attempted, failed, checks {name: value}) over every run of the
        window; the SNR on a sample of the delivered frames drawn from the
        seed."""
        attempted = failed = spurious = 0
        cfo_err = 0.0
        matched = []                              # (run, truth index, record index)
        arrays = []
        for r, (k, recs) in enumerate(self.runs):
            a = reference.records_arrays(recs)
            arrays.append(a)
            res = reference.check_stream(self.streams[k], self.pool, a)
            attempted += res["frames"]
            failed += len(res["bad"])
            spurious += res["spurious"]
            s = self.streams[k]
            for i, j in res["matched"].items():
                cfo_err = max(cfo_err, abs(a["cfo"][j] - s.cfo[i]))
                matched.append((r, i, j))
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed), 0x5A]))
        pick = rng.permutation(len(matched))[: int(self.conf["snr_sample"])]
        gaps = []
        for m in pick:
            r, i, j = matched[m]
            s = self.streams[self.runs[r][0]]
            pts = self.pool.points[(int(s.mcs[i]), int(s.length[i]))][int(s.entry[i])]
            ref = reference.snr_db(s.x[s.channel[i]], int(s.start[i]), float(s.cfo[i]),
                                   int(s.mcs[i]), int(s.length[i]), pts)
            gaps.append(arrays[r]["snr"][j] - ref)
        gaps = np.array(gaps) if gaps else np.array([np.inf])
        checks = {"frames_bad": failed,
                  "snr_gap_max_db": float(np.max(np.abs(gaps))),
                  "snr_bias_db": float(abs(np.mean(gaps)))}
        self.info = {"spurious_records": spurious, "snr_compared": int(len(pick)),
                     "cfo_err_max": float(cfo_err),
                     "runs": len(self.runs), "setup_parts": self.setup_parts,
                     "run_ms_min_median_max": [1e3 * float(np.min(self.run_s)),
                                               1e3 * float(np.median(self.run_s)),
                                               1e3 * float(np.max(self.run_s))]}
        return attempted, failed, checks


def _ranged(name: str, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapped
