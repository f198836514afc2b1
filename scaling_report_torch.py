"""Weak scaling of the port's sharded RX steps over N processes, and the
64-channel collect path (the analogue of scaling_report.py, which runs the
JAX package).

    python scaling_report_torch.py [--procs 1 2] [--device cuda|cpu]
                                   [--out scaling_torch.json]

Each leg starts N processes of this script (one rank each), joined into
one ``torch.distributed`` group at ``tcp://127.0.0.1:<free port>``: gloo
with ``--device cpu``, NCCL with one rank a card with ``--device cuda``
(N cards needed). Every rank holds the whole stream, as every host holds
the shared antenna feed.

  fixed     weak scaling: a (channels, N) mesh, each rank owning
            ``--channels`` channels of one time block, so the per-rank work
            stays the same and the halos cross the process boundaries.
            One ``run`` checks every frame back bit-exact, then the sharded
            step (``mesh_step``: halo exchange, sync, decode) is timed over
            ``--iters`` steps. Efficiency = aggregate samples/s at N over N
            x the rate at 1.
  adaptive  the SIGNAL-steered executor's whole ``run`` (stage A sharded,
            the gather, stage B replicated on every rank) on a (1, 2N) mesh
            of ``--adaptive-block`` blocks, mixed MCS 0/2/5/7 traffic;
            frames/s and bit-exact count.
  pod       ``StreamExecutor.run`` with ``--pod-channels`` channels on one
            device (local mode), and the Tracer's collect share of
            device_step + collect.

Rank 0 prints each leg's ``RESULT`` line; the script writes every result
to ``--out`` and prints the whole report as its last line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

MCS, L, K = 2, 50, 4


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2],
                    help="world sizes of the fixed and adaptive legs")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--channels", type=int, default=4, help="channels a rank owns (fixed leg)")
    ap.add_argument("--block", type=int, default=1 << 17, help="samples a time block (fixed)")
    ap.add_argument("--iters", type=int, default=8, help="timed steps (fixed)")
    ap.add_argument("--adaptive-block", type=int, default=1 << 15)
    ap.add_argument("--pod-channels", type=int, default=64)
    ap.add_argument("--pod-block", type=int, default=1 << 15)
    ap.add_argument("--out", default="scaling_torch.json")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a leg may take")
    ap.add_argument("--worker", nargs=4, metavar=("LEG", "RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    return ap.parse_args()


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fixed(args, dev, group, world):
    """Weak-scaling leg on this rank: returns the aggregate rate."""
    import torch
    import torch.distributed as dist

    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor, make_mesh
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    c, t, block = args.channels, world, args.block
    cfg = ExecutorConfig(block_size=block, time_shards=t, channels=c, max_frames_per_block=K,
                         wire_format="sc16")
    ex = StreamExecutor(tx.tx_plan(MCS, L), mesh=make_mesh(c, t, group=group), exec_cfg=cfg,
                        device=dev)
    rng = np.random.default_rng(0)
    n = t * block
    frames = rng.integers(0, 256, (2 * t, L), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=dev).cpu().numpy()
    # one frame across each rank seam (and one near the start), one inside each block
    pos = [600] + [i * block - 500 for i in range(1, t)] + [i * block + block // 2
                                                            for i in range(t)]
    x = np.zeros(n, np.complex64)
    for p, b in zip(pos, bursts):
        x[p: p + b.size] += 0.5 * b
    x += (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    stream = np.stack([x] * c)
    got = {(r.channel, r.psdu.tobytes()) for r in ex.run(stream) if r.parity_ok}
    want = {(ch, f.tobytes()) for ch in range(c) for f in frames}
    wire, _ = ex.mesh_layout(stream, 0)
    wire = torch.from_numpy(wire).to(dev)
    ex.mesh_step(wire)
    _sync(dev)
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        ex.mesh_step(wire)
    _sync(dev)
    dist.barrier(group)
    dt = time.perf_counter() - t0
    return {"nproc": world, "channels_per_rank": c, "block": block,
            "msps": c * t * block * args.iters / dt / 1e6,
            "frames": len(want), "bitexact": len(got & want)}


def _adaptive(args, dev, group, world):
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveStreamExecutor, make_mesh
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    block, t = args.adaptive_block, 2 * world
    cfg = ExecutorConfig(block_size=block, time_shards=t, max_frames_per_block=16)
    ex = AdaptiveStreamExecutor(mesh=make_mesh(1, t, group=group), exec_cfg=cfg, device=dev)
    rng = np.random.default_rng(1)
    n = t * block
    stream = (0.004 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    specs, placed, pos, i = [(m, 50) for m in (0, 2, 5, 7)], [], 700, 0
    while True:
        mcs, ln = specs[i % len(specs)]
        f = rng.integers(0, 256, (1, ln), dtype=np.uint8)
        b = tx.transmit(f, mcs, device=dev).cpu().numpy()[0]
        if pos + b.size + 600 > n:
            break
        stream[pos: pos + b.size] += 0.5 * b
        placed.append((mcs, pos, f[0]))
        pos += b.size + 2200
        i += 1
    ex.run(stream[None])                             # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    recs = ex.run(stream[None] * np.float32(1 + 1e-6))
    _sync(dev)
    wall = time.perf_counter() - t0
    ok = sum(any(r.parity_ok and r.rate_idx == mcs and abs(r.global_start - p) < 50
                 and np.array_equal(r.psdu, f) for r in recs) for mcs, p, f in placed)
    return {"nproc": world, "frames": len(placed), "bitexact": ok, "fps": ok / wall,
            "msps": n / wall / 1e6}


def _pod(args, dev):
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import Tracer

    ch, block, t = args.pod_channels, args.pod_block, 4
    cfg = ExecutorConfig(block_size=block, time_shards=t, channels=ch, max_frames_per_block=K)
    ex = StreamExecutor(tx.tx_plan(MCS, L), exec_cfg=cfg, device=dev)
    rng = np.random.default_rng(0)
    n = t * block
    frames = rng.integers(0, 256, (ch, 2, L), dtype=np.uint8)
    stream = np.zeros((ch, n), np.complex64)
    for c in range(ch):
        bursts = tx.transmit(frames[c], MCS, scrambler_seed=c % 127 + 1, device=dev).cpu().numpy()
        for i, b in enumerate(bursts):
            p = 500 + i * (n // 2) + 37 * c
            stream[c, p: p + b.size] += 0.5 * b
    stream += 0.005 * (rng.standard_normal(stream.shape)
                       + 1j * rng.standard_normal(stream.shape)).astype(np.complex64)
    want = {(c, frames[c][i].tobytes()) for c in range(ch) for i in range(2)}
    ok = {(r.channel, r.psdu.tobytes()) for r in ex.run(stream) if r.parity_ok}   # warm-up
    ex.tracer = Tracer()
    t0 = time.perf_counter()
    ex.run(stream * np.float32(1 + 1e-6))
    _sync(dev)
    wall = time.perf_counter() - t0
    stages = {k: v.seconds for k, v in ex.tracer.report().items()}
    step_s, collect_s = stages.get("device_step", 0.0), stages.get("collect", 0.0)
    return {"channels": ch, "samples": int(stream.size), "wall_s": wall,
            "msps": stream.size / wall / 1e6, "frames": len(want),
            "frames_bitexact": len(ok & want), "stages": stages,
            "collect_share": collect_s / max(step_s + collect_s, 1e-9)}


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    leg, rank, world, port = args.worker
    rank, world = int(rank), int(world)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        group = dist.group.WORLD
        dist.barrier(group)         # every rank's communicator up before the first exchange
        out = (_fixed(args, dev, group, world) if leg == "fixed"
               else _adaptive(args, dev, group, world) if leg == "adaptive"
               else _pod(args, dev))
        if rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def run_leg(args, leg: str, world: int) -> dict:
    """Start ``world`` ranks of one leg (with this run's arguments); rank
    0's RESULT."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:],
                               "--worker", leg, str(r), str(world), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{leg} rank {r} of {world} exited {p.returncode}:\n{out[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{leg}: rank 0 printed no RESULT line:\n{outs[0][-3000:]}")


def main() -> None:
    args = _parse()
    if args.worker:
        worker(args)
        return
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    report = {"device": (torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
              "backend": "nccl" if dev.type == "cuda" else "gloo", "fixed": {}, "adaptive": {}}
    for world in args.procs:
        r = run_leg(args, "fixed", world)
        if r["bitexact"] != r["frames"]:
            raise RuntimeError(f"fixed leg at {world} ranks: {r['bitexact']}/{r['frames']} frames")
        report["fixed"][world] = r
        print(f"fixed, {world} rank(s) x {args.channels} channels: {r['msps']:.1f} Msamples/s",
              flush=True)
    base = report["fixed"][min(args.procs)]
    for world, r in report["fixed"].items():
        r["efficiency"] = r["msps"] / (world / min(args.procs) * base["msps"])
    for world in args.procs:
        r = run_leg(args, "adaptive", world)
        if r["bitexact"] != r["frames"]:
            raise RuntimeError(f"adaptive leg at {world} ranks: {r['bitexact']}/{r['frames']}")
        report["adaptive"][world] = r
        print(f"adaptive, {world} rank(s): {r['msps']:.1f} Msamples/s, {r['fps']:.0f} frames/s, "
              f"{r['bitexact']}/{r['frames']} bit-exact", flush=True)
    pod = run_leg(args, "pod", 1)
    if pod["frames_bitexact"] != pod["frames"]:
        raise RuntimeError(f"pod leg: {pod['frames_bitexact']}/{pod['frames']} frames")
    report["pod"] = pod
    print(f"{pod['channels']}-channel run: {pod['msps']:.1f} Msamples/s, collect share "
          f"{pod['collect_share']:.1%}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
