"""What every cell shares: the command line, the cell's files found by
name, the card's check, the profiled slice and its reduction, the
per-layer readers, the import check and the result line.

A cell is found from ``BENCHMARK.json``: its workload entry names a
configuration (``configs/<config>.json``, whose ``system`` names the
module in ``harness/`` that runs it) and a traffic mix (``traffic/<traffic>.json``);
each per-layer metric is read by ``metrics/<name>.py``. Adding a cell or
a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent                                          # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "gnuradio_wifi_imagetransfer_tpu")
PROFILE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILE_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", help="a workload name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None,
                    help="length of the measured window (default: run_seconds)")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run every cell at tiny sizes on the CPU through the plain kernels; "
                         "prints no times")
    return ap.parse_args(argv)


def cpu_plan() -> dict | None:
    """The cores of a run on the card: one for the thread that drives the
    card (``drive``: the receiver's main thread, the radio's thread), one for
    the radio's load process (``load``), and the rest for every other thread
    (``rest``). None where the process may use fewer than four cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    return {"drive": cores[-1], "load": cores[-2], "rest": set(cores[:-2])}


def pin(cores) -> None:
    """Keep the calling thread, and the threads it starts from now on, on
    ``cores`` (a core or a set of them)."""
    os.sched_setaffinity(0, {cores} if isinstance(cores, int) else set(cores))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the cell ``name``."""
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    traffic = load_json(HERE / "traffic" / f"{work['traffic']}.json")
    return work, load_json(ROOT / conf["file"]), traffic


def metrics_of(spec: dict, name: str, trace: int) -> list[dict]:
    """The metric entries the cell reports: end-to-end without a trace,
    per-layer with one."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list[dict], ctx: dict) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and has no fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def device_entry(rehearse: bool) -> dict:
    import torch

    if rehearse:
        return {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(0))}


# -- the profiled slice ----------------------------------------------------


class Slice:
    """torch.profiler over a short slice of the window (CPU and CUDA
    activity), started and stopped on the thread that drives the card; the
    slice's bounds are the ``bench.slice`` range the caller opens inside
    it. ``events`` exports the trace, after the window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)

    def start(self):
        self.prof.start()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def short_name(name: str) -> str:
    """A kernel's or op's name without its namespace, signature and
    template arguments, at most 96 characters."""
    n = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if n.startswith("void "):
        n = n[5:]
    return n.split("<")[0][:96] or name[:96]


def reduce_trace(events: list, spans: str = "bench.") -> dict:
    """A slice's chrome-trace events -> {"busy_s", "window_s", "kernel_s"
    {short name: s}, "ops" [[name, s]] top 10 device operations, "gaps"
    [[label, s]] the 10 longest idle gaps labelled by the host op and
    benchmark span inside them, "spans" [(name, t0, t1)] of the benchmark's
    ranges, in seconds of the trace's clock}."""
    sl = [e for e in events if e.get("ph") == "X" and e.get("name") == "bench.slice"]
    if not sl:
        return {}
    w0, w1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    dev = sorted(((e["ts"], e["ts"] + e["dur"], e) for e in events
                  if e.get("ph") == "X" and e.get("cat") in PROFILE_DEVICE_CATS
                  and e["ts"] < w1 and e["ts"] + e["dur"] > w0), key=lambda t: t[:2])
    by_name: dict[str, float] = {}
    kernel_s: dict[str, float] = {}
    union, cur = [], None
    for a, b, e in dev:
        n = short_name(e["name"])
        by_name[n] = by_name.get(n, 0.0) + e["dur"] * 1e-6
        if e["cat"] == "kernel":
            kernel_s[n] = kernel_s.get(n, 0.0) + e["dur"] * 1e-6
        a, b = max(a, w0), min(b, w1)
        if cur is None or a > cur[1]:
            cur = [a, b]
            union.append(cur)
        else:
            cur[1] = max(cur[1], b)
    busy = sum(b - a for a, b in union)
    edges = [w0] + [x for iv in union for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat")) for e in events
            if e.get("ph") == "X" and e.get("cat") in PROFILE_HOST_CATS
            and e["name"] != "bench.slice"]
    labelled = []
    for dur, a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in host if h[0] <= mid <= h[1]]
        bench_spans = [h for h in inside if h[2].startswith(spans)]
        ops = [h for h in inside if not h[2].startswith(spans)]
        span = min(bench_spans, key=lambda h: h[1] - h[0])[2].split("#")[0] if bench_spans else ""
        op = short_name(min(ops, key=lambda h: h[1] - h[0])[2]) if ops else ""
        label = " > ".join(x for x in (span, op) if x) or "no host op (waiting)"
        labelled.append([label, dur * 1e-6])
    bench_spans = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(spans) and e["name"] != "bench.slice"]
    kernels = [(e["ts"] * 1e-6, short_name(e["name"]), e["dur"] * 1e-6) for _, _, e in dev
               if e["cat"] == "kernel"]
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6, "kernel_s": kernel_s,
            "ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "gaps": labelled, "spans": bench_spans, "kernels": kernels}


class GcPauses:
    """The garbage collector's pauses while the block runs (host clock)."""

    def __enter__(self):
        import gc
        import time

        self._clock, self._t0, self.pauses = time.perf_counter, None, []
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = self._clock()
        elif self._t0 is not None:
            self.pauses.append((info["generation"], self._clock() - self._t0))

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        ms = [1e3 * d for _, d in self.pauses]
        return {"collections": len(ms), "full": sum(g == 2 for g, _ in self.pauses),
                "total_ms": sum(ms), "max_ms": max(ms, default=0.0)}


# -- the result --------------------------------------------------------------


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: dict, breakdown: dict | None = None, extra: dict | None = None) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output;
    ``checks`` is the result's last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if extra:
        line.update(extra)
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
