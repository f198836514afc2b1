"""The radio cells: Mode-2 pieces over UDP through ``LoopbackRadio``.

The load generator and the receiving socket run in a process of their own
(loadgen.py), which imports neither torch nor the program, sends on a
schedule that never slows for the radio, and times every piece from its
due time to its arrival at the receiving socket. This process holds the
radio: the UDP source on a free port, MAC framing, the group on the card
(TX, the channel at the configured SNR, the receive) and the sink that
sends each payload on to the load process.

Set-up captures the graph of every group the pieces can form (each MPDU
length the pieces have, each group size up to ``batch``) through the
radio's own ``_process``, then starts the radio and runs a short live
phase through the sockets. The window is one phase of the traffic. With
``trace``, each ``_process`` call is timed and marked by a
``bench.radio_batch`` range (a wrapper on the object), and a short slice
in the middle of the window is profiled on the radio's thread.

After the window, one short phase of the same radio with its probes on
hands the benchmark the head of the channel's output of each group: the
samples before and after each burst, where the TX sends zeros, are the
channel's noise alone, and the burst's own samples its signal and noise.
The reference holds the SNR they give to the configured one.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

from harness import common
from harness.common import HERE
from yardstick import reference, vtx

SLICE_S = 0.15                     # the profiled slice, in the window's middle
MAC_BYTES = 28                     # the MPDU's 24-byte header and 4-byte FCS around a datagram


class Cell:
    def __init__(self, work: dict, config: dict, traffic: dict, seed: int, rehearse: bool,
                 overrides: dict | None = None, cpus: dict | None = None):
        self.work, self.conf, self.traffic = work, dict(config), dict(traffic)
        if rehearse:
            self.conf = {**self.conf, **self.conf.get("rehearse", {})}
            self.traffic = {**self.traffic, **self.traffic.get("rehearse", {})}
        self.seed, self.rehearse, self.cpus = seed, rehearse, cpus
        self.control = (overrides or {}).get("control")
        self.batches: list = []           # (t0, t1, {datagram length: count})
        self.gen = self.radio = self.slice = self.slice_range = self.arm_at = None
        self.heads: list = []             # (MPDU length, channel output head) a probed group
        self.probed = None

    # -- the load process ----------------------------------------------------

    def _start_loadgen(self) -> dict:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.gen = subprocess.Popen(
            [sys.executable, str(HERE / "loadgen.py"), "--seed", str(self.seed),
             "--image", *map(str, self.traffic["image"]), "--piece",
             *map(str, self.traffic["piece"]),
             *(["--cpu", str(self.cpus["load"])] if self.cpus else [])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
        return json.loads(self.gen.stdout.readline())

    def _cmd(self, **cmd) -> None:
        self.gen.stdin.write(json.dumps(cmd) + "\n")
        self.gen.stdin.flush()

    def phase(self, rate: float, seconds: float, pattern: str | None = None,
              on_start=None) -> dict:
        """One window of the load process; ``on_start(t0)`` runs in this
        thread while the phase goes on. Returns its result."""
        t0 = time.monotonic() + 0.05
        self._cmd(cmd="phase", t0=t0, rate=rate, seconds=seconds,
                  pattern=pattern or self.traffic["pattern"], burst=self.traffic.get("burst", 1),
                  wait_s=self.conf["wait_s"])
        if on_start is not None:
            on_start(t0)
        return json.loads(self.gen.stdout.readline())

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        import torch

        from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio

        t0 = time.perf_counter()
        hello = self._start_loadgen()
        r = self.conf["radio"]
        self.device = torch.device("cpu" if self.rehearse else "cuda")
        self.radio = LoopbackRadio(in_port=0, out_port=hello["recv_port"], mcs=r["mcs"],
                                   snr_db=r["snr_db"], epsilon=r["epsilon"], batch=r["batch"],
                                   seed=self.seed % (1 << 63), probes=r["probes"],
                                   device=self.device)
        self._cmd(cmd="target", port=self.radio.in_port)
        self._inject()
        t1 = time.perf_counter()
        for n in hello["payload_lengths"]:
            for b in range(1, r["batch"] + 1):
                self.radio._process([bytes(n)] * b)
        if self.cpus:
            self._pin_radio_thread(self.cpus["drive"])
        self.radio.start()
        t2 = time.perf_counter()
        self.warm = self.phase(self.traffic["rate"], self.traffic["warm_s"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"radio_s": t1 - t0, "graphs_s": t2 - t1,
                            "live_warm_s": time.perf_counter() - t2}

    def _inject(self) -> None:
        """The control, which breaks the exactly-once guarantee underneath
        the radio: its sink sends every payload twice."""
        if self.control == "twice":
            send = self.radio.sink.send_mac_payload

            def twice(p):
                send(p)
                send(p)
            self.radio.sink.send_mac_payload = twice

    def _pin_radio_thread(self, core: int) -> None:
        """Put the radio's thread on ``core`` from its first drain of the
        UDP source on."""
        source = self.radio.source
        drain = source.drain

        def first_drain(*a, **kw):
            common.pin(core)
            source.drain = drain
            return drain(*a, **kw)
        source.drain = first_drain

    def _wrap_process(self) -> None:
        from torch.profiler import record_function

        orig = self.radio._process

        @functools.wraps(orig)
        def process(payloads):
            if self.arm_at is not None and time.monotonic() >= self.arm_at:
                self.arm_at = None
                self._slice_start()
            sizes: dict[int, int] = {}
            for p in payloads:
                sizes[len(p)] = sizes.get(len(p), 0) + 1
            i = len(self.batches)
            t0 = time.perf_counter()
            with record_function(f"bench.radio_batch#{i}"):
                orig(payloads)
            self.batches.append((t0, time.perf_counter(), sizes))
            if self.slice_range is not None and time.perf_counter() - self.slice_t0 >= SLICE_S:
                self._slice_stop()
        self.radio._process = process

    def _slice_start(self) -> None:
        """Open the profiled slice on the radio's thread, at a batch's edge."""
        from torch.profiler import record_function

        self.slice = self.slice_cls()
        self.slice.start()
        self.slice_range = record_function("bench.slice")
        self.slice_range.__enter__()
        self.slice_t0 = time.perf_counter()

    def _slice_stop(self) -> None:
        self.slice_range.__exit__(None, None, None)
        self.slice_range = None
        self.slice.stop()

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float, trace: bool, slice_cls=None) -> None:
        self.slice_cls = slice_cls
        if trace:
            self._wrap_process()
            # a profiler's first start on a thread sets up CUPTI for seconds, in
            # which the radio stalls: pay it in a live phase before the window
            self.phase(self.traffic["rate"], 2.0,
                       on_start=lambda t0: setattr(self, "arm_at", t0 + 0.2))
            self.arm_at = None
            if self.slice_range is not None:
                self._slice_stop()
            self.slice = None
        cap0 = self.radio.graphs.captured
        in0 = self.radio.stats["datagrams_in"]
        crc0 = self.radio.stats["frames_crc_fail"]
        self.first_batch = len(self.batches)

        def arm(t0):
            if trace:                     # the radio's thread profiles mid-window
                self.arm_at = t0 + seconds / 2

        self.result = self.phase(self.traffic["rate"], seconds, on_start=arm)
        self.last_batch = len(self.batches)
        self.arm_at = None
        if self.slice_range is not None:
            self._slice_stop()
        self.captures = self.radio.graphs.captured - cap0
        self.datagrams_in = self.radio.stats["datagrams_in"] - in0
        self.crc_fail = self.radio.stats["frames_crc_fail"] - crc0

    def after_window(self) -> None:
        """The channel's probe: a short phase of the same radio with its
        probes on (graphs of their own, captured here, after the window),
        keeping the head of the channel's output of every group with the
        MPDU length of its frames (groups go in order of first appearance
        of a length, as the radio forms them)."""
        radio, probe = self.radio, self.conf["channel_probe"]
        process, update = radio._process, radio.spectrum.update
        lengths: list = []

        def process_(payloads):
            lengths[:] = list(dict.fromkeys(len(p) + MAC_BYTES for p in payloads))
            process(payloads)

        def update_(head):
            self.heads.append((lengths.pop(0), np.array(head)))
            update(head)
        radio._process, radio.spectrum.update = process_, update_
        radio.probes = True
        self.probed = self.phase(probe["rate"], probe["seconds"])

    def release(self) -> None:
        """Stop the radio and the load process, and wait for both."""
        if self.radio is not None:
            self.radio.stop()
            self.radio = None
        if self.gen is not None:
            try:
                self._cmd(cmd="quit")
                self.gen.stdin.close()
                self.gen.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.gen.kill()
                self.gen.wait()
            self.gen = None
        import gc

        gc.collect()

    # -- results ------------------------------------------------------------------

    def end_to_end(self) -> dict:
        r = self.result
        return {"piece_latency_p50_ms": r["lat_p50_ms"], "piece_latency_p95_ms": r["lat_p95_ms"]}

    def layer_context(self, reduce) -> dict:
        """The traced window's spans, counters and profiled slice."""
        calls = self.batches[self.first_batch: self.last_batch]
        ctx = {"batch_s": [b[1] - b[0] for b in calls],
               "batch_sizes": [sum(b[2].values()) for b in calls],
               "captures": self.captures, "profile": None}
        if self.slice is not None:
            p = reduce(self.slice.events())
            spans = [(int(n.split("#")[1]), a, b) for n, a, b in p["spans"]
                     if n.startswith("bench.radio_batch#")]
            work = {"k1_samples": 0, "k1_rows": 0, "k1_slots": 0, "k2_steps": 0}
            kernel_s: dict = {}
            mcs = self.conf["radio"]["mcs"]
            for i, a, b in spans:
                for length, g in self.batches[i][2].items():
                    mpdu = length + 28
                    work["k1_samples"] += g * (100 + vtx.burst_len(mcs, mpdu) + 400)
                    work["k1_rows"] += 1
                    work["k1_slots"] = max(work["k1_slots"], 2 * g)
                    work["k2_steps"] += g * (24 + vtx.trellis_steps(mpdu))
                for t, name, d in p["kernels"]:
                    if a <= t <= b:
                        kernel_s[name] = kernel_s.get(name, 0.0) + d
            p["kernel_s"], p["work"] = kernel_s, work
            ctx["profile"] = p
        return ctx

    def check(self) -> tuple[int, int, dict]:
        r = self.result
        ch = self.conf["channel"]
        snr = reference.channel_snr(self.heads, self.conf["radio"]["mcs"], ch["pad"],
                                    ch["scale"], self.conf["radio"]["snr_db"],
                                    ch["noise_voltage"], self.seed)
        checks = {"pieces_lost": r["lost"], "pieces_corrupt": r["corrupt"],
                  "pieces_duplicated": r["duplicated"],
                  "channel_snr_gap_db": snr["gap_db"]}
        failed = r["lost"] + r["corrupt"] + r["duplicated"]
        self.info = {"delivered": r["delivered"], "generator_late_p50_ms": r["late_p50_ms"],
                     "generator_late_max_ms": r["late_max_ms"], "latency_max_ms": r["lat_max_ms"],
                     "datagrams_in": self.datagrams_in, "frames_crc_fail": self.crc_fail,
                     "setup_parts": self.setup_parts,
                     "channel": {k: snr[k] for k in ("groups", "snr_db", "ref_snr_db",
                                                     "noise_power")},
                     "probe_delivered": (f"{self.probed['delivered']}/{self.probed['attempted']}"
                                         if self.probed else None),
                     "warm_delivered": f"{self.warm['delivered']}/{self.warm['attempted']}"}
        return r["attempted"], failed, checks
