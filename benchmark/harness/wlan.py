"""The WLAN receiver cell: ``AdaptiveStreamExecutor.run`` over
four-channel 802.11a/g streams of ordinary IP traffic, a rate and a PSDU
length drawn for every frame (yardstick/ip_mix.py), in a closed loop.

It is the receiver cell of ``harness.rx`` with two changes. Set-up makes
the IP-mix streams. And the traced run adds stage B's padding: the
executor's Tracer counters ``stage_b_slots`` (calls: the buckets; samples:
padded rows x each bucket's class symbols) and ``stage_b_symbols``
(samples: the frames' own data symbols), over the window; where the
program keeps no such counters they are None and their readers report
nothing.

The window may compile nothing, so the warm-up has to leave every CUDA
graph the window replays in the executor's ``GraphCache``. This traffic
makes about 1 370 distinct (rate, length) pairs a run: a program that
keys a stage-B graph on each has more keys than the cache holds, and
would capture inside the window at nearly every bucket. Set-up checks
the cache after each warm-up run and ends the cell with an error as soon
as it has captured more graphs than it holds, since some of them were
evicted and the window would capture them again.
"""

from __future__ import annotations

import time

from harness import common, rx
from yardstick import ip_mix

COUNTERS = ("stage_b_slots", "stage_b_symbols")


class Cell(rx.Cell):
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
        self.pool, self.streams = ip_mix.make_streams(self.traffic, self.channels, self.n,
                                                      self.block, self.seed)
        t2 = time.perf_counter()
        if self.cpus:
            common.pin(self.cpus["drive"])           # this thread drives the card
        for s in [*self.streams, self.streams[0]]:   # every graph key of the window
            self.ex.run(s.x)
            resident(self.ex.graphs)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"program_s": t1 - t0, "traffic_s": t2 - t1,
                            "warm_s": time.perf_counter() - t2}

    def window(self, seconds: float, trace: bool, slice_cls=None) -> None:
        super().window(seconds, trace, slice_cls)
        report = self.ex.tracer.report()
        self.counters = {name: report.get(name) for name in COUNTERS}

    def layer_context(self, reduce) -> dict:
        ctx = super().layer_context(reduce)
        ctx.update(self.counters)
        return ctx


def resident(graphs) -> None:
    """Raise SystemExit where ``graphs`` (a ``GraphCache``) has captured more
    graphs than it holds: the ones it evicted would be captured again inside
    the window."""
    if graphs.captured > graphs.MAX_GRAPHS:
        raise SystemExit(f"the warm-up captured {graphs.captured} CUDA graphs and the cache "
                         f"holds {graphs.MAX_GRAPHS}: the window would capture again, so this "
                         f"program cannot run the cell without compiling inside it")
