"""Run one cell of the benchmark on the card, or rehearse every cell on the CPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 benchmark/run.py --rehearse

A cell is an entry of BENCHMARK.json's ``workloads``. Set-up (imports,
CUDA, the kernels from their build cache, the traffic, the warm-up of every
graph the window needs) is timed from the first line of this file to the
window's first instant. The window lasts ``--seconds``. Then the device's
peak memory is read, the cell takes what else its check needs from the
program (the radio's channel probe), the program's state is freed, and
what the window produced is held to the plain reference. The last line of
standard output is the result; the numbers compared, each beside its
limit, close standard error and the result's line.

``--trace 1`` reports the per-layer metrics instead of the end-to-end ones,
from the host spans and counters of the whole window and a short slice of
it under torch.profiler. ``--rehearse`` runs every cell at the tiny sizes
of its files' ``rehearse`` entries through the port's plain kernels on the
CPU and prints no times.

On the card the run keeps its threads on fixed cores (``common.cpu_plan``):
the thread that drives the card on one, the radio's load process on
another, everything else on the rest.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import gc  # noqa: E402
import importlib  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import common  # noqa: E402

REHEARSE_SECONDS = 2.0


def run_cell(name: str, seed: int, seconds: float | None, trace: int, rehearse: bool = False,
             overrides: dict | None = None, cpus: dict | None = None):
    """One cell: set-up, window, reference check. Returns the result dict
    that ``emit`` prints (``setup_s`` among the metrics). ``cpus`` is
    ``common.cpu_plan()``'s, with this thread already on its ``rest``."""
    spec = common.bench()
    work, conf, traffic = common.cell(spec, name)
    if seconds is None:
        seconds = REHEARSE_SECONDS if rehearse else float(spec["run_seconds"])
    if not rehearse:
        common.require_cards(int(work["chips"]))
    import torch

    if rehearse:
        torch.set_num_threads(2)
    elif cpus:
        torch.set_num_threads(len(cpus["rest"]))
        torch.ones(1 << 20).sum()       # start torch's CPU threads now, on the rest
    system = importlib.import_module(f"harness.{conf['system']}")
    c = system.Cell(work, conf, traffic, seed, rehearse, overrides=overrides, cpus=cpus)
    imports_s = time.perf_counter() - T_START
    c.setup()
    gc.collect()
    gc.freeze()           # set-up's objects live for the whole run: keep the collector off them
    setup_s = time.perf_counter() - T_START
    with common.GcPauses() as pauses:
        c.window(seconds, bool(trace), slice_cls=common.Slice)
    device = common.device_entry(rehearse)
    c.after_window()
    if trace:
        ctx = c.layer_context(common.reduce_trace)
        metrics = common.read_metrics(common.metrics_of(spec, name, 1), ctx)
        prof = ctx.get("profile")
        if prof and not rehearse:
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
        breakdown = ({"device_ops": prof["ops"], "idle_gaps": prof["gaps"]}
                     if prof else None)
    else:
        metrics = dict(c.end_to_end())
        metrics["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        wanted = {m["name"] for m in common.metrics_of(spec, name, 0)}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in metrics.items()
                   if k in wanted and v is not None}      # None: a tail over lost pieces
        breakdown = None
    c.release()
    attempted, failed, values = c.check()
    limits = conf["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in values.items())
    read = sorted(metrics)
    if rehearse:
        metrics = {}
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, "checks": checks, "breakdown": breakdown,
            "extra": {"info": {**c.info, "imports_s": imports_s, "gc_in_window": pauses.summary()}},
            "read": read}


def main(argv=None) -> int:
    args = common.parse_args(argv)
    if args.rehearse:
        spec = common.bench()
        ok = True
        names = [args.workload] if args.workload else [w["name"] for w in spec["workloads"]]
        for name in names:
            res = run_cell(name, args.seed, args.seconds, args.trace, rehearse=True)
            print(f"rehearsal {name}: correct={res['correct']} attempted={res['attempted']} "
                  f"failed={res['failed']} metrics read={res['read']} checks={res['checks']} "
                  f"info={res['extra']['info']}", flush=True)
            ok &= res["correct"]
        return 0 if ok else 1
    if not args.workload:
        raise SystemExit("--workload is required (or --rehearse)")
    cpus = common.cpu_plan()
    if cpus:
        common.pin(cpus["rest"])        # before torch and CUDA start their threads
    res = run_cell(args.workload, args.seed, args.seconds, args.trace, cpus=cpus)
    found = common.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    common.emit(res["correct"], res["attempted"], res["failed"], res["metrics"], res["device"],
                res["checks"], res["breakdown"], res["extra"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
