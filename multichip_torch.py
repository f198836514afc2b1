"""The port's multi-card dry run: the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, over N ranks of one
``torch.distributed`` group.

    python multichip_torch.py [--procs 1 2 4] [--device cuda|cpu] [--dryrun]
                              [--seed 0] [--train-npz NPZ]
                              [--out multichip_torch.json] [--timeout 900]

For each world size of ``--procs`` in turn, this script starts that many
worker processes of itself, joined into one group at
``tcp://127.0.0.1:<free port>``: NCCL with one rank a card (``--device
cuda``, the default; card r is rank r's), gloo with ``--device cpu``.
Every rank builds the same streams from ``--seed`` with numpy and the
port's TX and holds the whole feed, as every host does in JAX's protocol.
The ranks then run four legs, at full width unless ``--dryrun``:

  fixed     ``StreamExecutor`` on ``make_mesh(4, 16)`` at the bench shape
            (chip_smoke.py phase 28): 4 channels of 2 super-blocks of 16
            blocks of 262 144 sc16 samples, 4 slots, frames across every
            block seam (rank seams included) and one flush against the
            stream's end; then again on JAX's dry-run layout
            ``make_mesh(2 if N is even else 1)`` at the same block, so that
            channel cells split over ranks too ("fixed-jax-layout");
  adaptive  ``AdaptiveStreamExecutor`` on (1, 4) cells, 128 slots, sc8, on
            phase 29's mixed stream (2 super-blocks of 4 x 262 144 samples,
            MCS 0-7 in turn);
  frontend  ``StreamExecutor`` with ``FrontendConfig(resample=(1, 2),
            ppm=40)`` on (4, 16) cells, on phase 11's 2x +40 ppm capture;
  train     2 m2m steps of ``SOMANet`` at the reference geometry (240 x
            240, c = 128, 2 users x 8 kodim crops, warm from the packaged
            npz) on ``make_data_mesh`` over the group, the per-user batch
            split over the ranks.

``--dryrun`` takes JAX's dry-run shapes instead: the streams of
``dryrun_multichip(8)`` (2 channels of 4 blocks of 4 096 samples, 2
frames a channel; the mixed MCS 0 / 7 stream; its 2x-oversampled copy) on
``make_mesh(2 if N is even else 1)`` over the N ranks for the three
executor legs, and ``SOMANet(32, 16, n_irs=4)`` with 8 crops a user,
seeded or from ``--train-npz``.

Every frame must come back bit-exact at its rate, and on rank 0 the good
records must equal the local executor's on the same stream; the trainer's
losses, first gradients, parameters and batch statistics must lie within
chip_smoke.py's SMALL_* tolerances of the one-rank Trainer, and every
rank's parameters must equal rank 0's. On the card, rank 0 holds the first
calls of K1 and K2 against their plain versions, and every rank's
launches must be one detector and one Viterbi launch a step. A rank that
fails ends the world and the script with a non-zero exit.

Each leg reports the host wall time of a warm whole ``run`` at N ranks
(``torch.cuda.synchronize`` and a barrier before and after), each rank's
Tracer stages, ``mesh_step`` in ms by CUDA events, each rank's launches
of ``sync_detect``, ``viterbi_decode`` and ``viterbi_decode_many``, and
for ``train`` the warm step in ms and the bytes of the flat gradient
all-reduce. The script writes the report to ``--out``, with each leg's
run time over the worlds (strong scaling: a fixed total shape over 1, 2
and 4 ranks), and prints it as its last line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
import make_weights_torch as mwt
from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, FrontendConfig
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights
from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, pe_labels
from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveStreamExecutor,
    StreamExecutor,
    make_data_mesh,
    make_mesh,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import HALO_LEFT
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve
from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import Tracer
from gnuradio_wifi_imagetransfer_tpu_torch.utils.trainer import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
MCS, L = cs.MCS, cs.PSDU_LEN
DRY_BLOCK, DRY_BLOCKS, DRY_CHANNELS, DRY_FRAMES = 4096, 4, 2, 2   # dryrun_multichip(8)'s
DRY_TRAIN = (16, 32, 4)                # SOMANet(compressed_channel=32, img_size=16, n_irs=4)
TRAIN_BATCH = 8                        # crops a user, split over the ranks
HELD = 2                               # rank 0's first calls of each kernel held


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4],
                    help="world sizes, run in turn")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo)")
    ap.add_argument("--dryrun", action="store_true", help="JAX's dry-run shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-npz", help="SOMANet variables to start the train leg from "
                                        "(default: the packaged npz; --dryrun: seeded)")
    ap.add_argument("--out", default="multichip_torch.json")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a world may take (also the group's collective timeout)")
    ap.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    return ap.parse_args()


def jax_layout(world: int) -> tuple[int, int]:
    """``dryrun_multichip``'s (channel, time) mesh for ``world`` devices."""
    channels = 2 if world % 2 == 0 and world > 1 else 1
    return channels, world // channels


def records_digest(records) -> str:
    """A digest of the parity-good records' (channel, global_start,
    rate_idx, psdu): equal digests, equal good records."""
    good = sorted((int(r.channel), int(r.global_start), int(r.rate_idx),
                   np.asarray(r.psdu, np.uint8).tobytes()) for r in records if r.parity_ok)
    h = hashlib.sha256()
    for c, g, m, p in good:
        h.update(f"{c},{g},{m},".encode() + p)
    return h.hexdigest()[:16]


# -- streams ------------------------------------------------------------------


def example_block(n: int, n_frames: int, seed: int, device):
    """``__graft_entry__._example_block`` with the port's TX: n_frames
    50-byte MCS-2 frames spread over n samples of noise 0.01."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, L), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=device).cpu().numpy()
    x = np.zeros(n, np.complex64)
    gap = n // max(n_frames, 1)
    for i, b in enumerate(bursts):
        pos = min(200 + i * gap, n - b.size - 1)
        x[pos: pos + b.size] += 0.5 * b
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64), frames


def dry_mixed(n: int, channels: int, seed: int, device):
    """``dryrun_multichip``'s mixed stream: an MCS-0 frame at 600 and an
    MCS-7 one at n/2 (+300 a channel). Returns ((channels, n), [(channel,
    rate, psdu bytes)])."""
    rng = np.random.default_rng(seed)
    rows, sent = [], []
    for ci in range(channels):
        specs = [(600, 0, rng.integers(0, 256, 50, dtype=np.uint8)),
                 (n // 2 + 300 * ci, 7, rng.integers(0, 256, 80, dtype=np.uint8))]
        x = np.zeros(n, np.complex64)
        for i, (pos, mcs, payload) in enumerate(specs):
            b = tx.transmit(payload[None], mcs, scrambler_seed=i + 1, device=device)[0]
            b = b.cpu().numpy()
            x[pos: pos + b.size] += 0.5 * b
            sent.append((ci, mcs, payload.tobytes()))
        x += 0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        rows.append(x.astype(np.complex64))
    return np.stack(rows), sent


def fft_2x(stream: np.ndarray) -> np.ndarray:
    """``dryrun_multichip``'s 2x oversampling by FFT zero padding (numpy)."""
    n = stream.shape[-1]
    up = np.fft.fft(stream, axis=-1)
    up2 = np.zeros(stream.shape[:-1] + (2 * n,), np.complex64)
    up2[..., : n // 2] = up[..., : n // 2]
    up2[..., -(n // 2):] = up[..., -(n // 2):]
    return (np.fft.ifft(up2, axis=-1) * 2).astype(np.complex64)


@dataclasses.dataclass
class MeshRun:
    """One executor leg: its mesh (channel, time), its config, its input and
    the frames that must come back, {(channel, rate, psdu bytes)}."""
    label: str
    mesh: tuple[int, int]
    cfg: object
    stream: np.ndarray
    sent: set
    adaptive: bool = False


def seam_stream(channels: int, n: int, block: int, seed: int, device):
    """Phase 28's stream: frames across every block seam, one inside each
    block, one flush against the end (``chip_smoke.seam_positions``)."""
    positions = cs.seam_positions(n, block)
    rng = np.random.default_rng(seed)
    rows, sent = [], set()
    for ch in range(channels):
        x, frames = cs.make_stream(tx, n, positions, len(positions), rng, device)
        rows.append(x)
        sent |= {(ch, MCS, f.tobytes()) for f in frames}
    return np.stack(rows), sent


def full_runs(world: int, seed: int, dev) -> list[MeshRun]:
    """The executor legs at full width (chip_smoke.py phases 11, 28, 29)."""
    block, t, c = cs.BLOCK, cs.TIME_BLOCKS, cs.CHANNELS
    cfg = ExecutorConfig(block_size=block, time_shards=t, channels=c,
                         max_frames_per_block=cs.MAX_FRAMES, wire_format="sc16")
    runs = []
    stream, sent = seam_stream(c, cs.MESH_SUPERBLOCKS * t * block, block, 28 + seed, dev)
    runs.append(MeshRun("fixed", (c, t), cfg, stream, sent))
    jc, jt = jax_layout(world)
    stream, sent = seam_stream(jc, cs.MESH_SUPERBLOCKS * jt * block, block, 280 + seed, dev)
    runs.append(MeshRun("fixed-jax-layout", (jc, jt), dataclasses.replace(
        cfg, time_shards=jt, channels=jc), stream, sent))

    aspan = cs.ADAPTIVE_SHARDS * block
    x, psdus, mcs_seq = cs.adaptive_stream(tx, mac, None, 2 * aspan,
                                           np.random.default_rng(29 + seed), dev)
    runs.append(MeshRun("adaptive", (1, cs.ADAPTIVE_SHARDS), ExecutorConfig(
        block_size=block, time_shards=cs.ADAPTIVE_SHARDS, max_frames_per_block=cs.ADAPTIVE_SLOTS,
        wire_format="sc8"), x, {(0, int(m), f.tobytes()) for m, f in zip(mcs_seq, psdus)},
        adaptive=True))

    # phase 11's capture: the executor's stream 2x oversampled by FFT on
    # the device, then skewed by +40 ppm on the host (a thread a channel)
    n = t * block
    n_frames = cs.FRAMES_PER_BLOCK * t
    positions = [min(150 + i * (n // n_frames), n - 2000) for i in range(n_frames)]
    rng = np.random.default_rng(seed)
    rows, sent = [], set()
    for ch in range(c):
        x, frames = cs.make_stream(tx, n, positions, n_frames, rng, dev)
        rows.append(x)
        sent |= {(ch, MCS, f.tobytes()) for f in frames}
    up2 = cs.fft_oversample(torch.from_numpy(np.stack(rows)).to(dev), 2).cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(c) as pool:
        cap = np.stack(list(pool.map(lambda row: cs.sample_clock_offset(row, 40.0), up2)))
    runs.append(MeshRun("frontend", (c, t), dataclasses.replace(
        cfg, frontend=FrontendConfig(resample=(1, 2), ppm=40.0)), cap, sent))
    return runs


def dry_runs(world: int, seed: int, dev) -> list[MeshRun]:
    """The executor legs at ``dryrun_multichip(8)``'s shapes on JAX's layout
    for ``world`` ranks (the stream spans several super-blocks on fewer
    than 8 cells)."""
    mesh = jax_layout(world)
    n = DRY_BLOCKS * DRY_BLOCK
    cfg = ExecutorConfig(block_size=DRY_BLOCK, time_shards=mesh[1], channels=DRY_CHANNELS,
                         max_frames_per_block=DRY_FRAMES)
    rows, sent = [], set()
    for ci in range(DRY_CHANNELS):
        x, frames = example_block(n, DRY_FRAMES, ci + seed, dev)
        rows.append(x)
        sent |= {(ci, MCS, f.tobytes()) for f in frames}
    stream = np.stack(rows)
    mixed, msent = dry_mixed(n, DRY_CHANNELS, 7 + seed, dev)
    return [MeshRun("fixed", mesh, cfg, stream, sent),
            MeshRun("adaptive", mesh, cfg, mixed, set(msent), adaptive=True),
            MeshRun("frontend", mesh, dataclasses.replace(
                cfg, frontend=FrontendConfig(resample=(1, 2))), fft_2x(stream), sent)]


def train_model(args, dev):
    """The train leg's SOMANet: at full width the reference geometry warm
    from the packaged npz (chip_smoke.py phase 30), with ``--dryrun``
    SOMANet(32, 16, n_irs=4) seeded; ``--train-npz`` names other starting
    variables."""
    if args.dryrun:
        img, c, n_irs = DRY_TRAIN
        npz = args.train_npz
    else:
        img, c, asset = mwt.GEOMETRIES["ref"][:3]
        n_irs = 16
        npz = args.train_npz or weights.ASSETS / asset
    model = SOMANet(c, img, n_irs, seed=args.seed, device=dev)
    if npz is not None:
        variables, _ = weights.load_soma_npz(npz)
        model.load_state_dict(weights.state_dict_from_flax(variables, model))
    return model


def train_batches(img: int, seed: int) -> np.ndarray:
    """The train leg's 2 batches, (2, U, TRAIN_BATCH, img, img, 3) uint8
    kodim crops (phase 30's draws)."""
    rng = np.random.default_rng(30 + seed)
    pool = mwt.load_kodak(mwt.TRAIN_IMAGES)
    return np.stack([np.stack([mwt.crops(rng, pool, TRAIN_BATCH, size=img)
                               for _ in range(mwt.U)]) for _ in range(2)])


# -- one rank -------------------------------------------------------------------


@dataclasses.dataclass
class Rank:
    """This worker's place in the group, its device and the kernels whose
    launches it counts."""
    args: argparse.Namespace
    dev: object
    group: object
    rank: int
    world: int
    kernels: list

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()
        dist.barrier(self.group, device_ids=[self.dev.index] if self.cuda else None)

    def reset(self):
        for k in self.kernels:
            k.launches = 0

    def counts(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        return {k.__name__: k.launches for k in self.kernels}

    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def check(self, cond: bool, msg: str) -> None:
        if not cond:
            raise RuntimeError(f"rank {self.rank} of {self.world}: {msg}")


def _steps(ex, stream) -> int:
    """The super-block steps an executor's ``run`` takes on ``stream``."""
    span = ex.time_shards * ex.block
    stride = span if ex.frontend is not None else span - (ex.halo_right + HALO_LEFT)
    return len(range(0, ex.effective_len(stream.shape[1]), stride))


def _make(run: MeshRun, group, dev):
    """The run's executor: on its mesh over ``group``, or local (group None)."""
    mesh = None if group is None else make_mesh(*run.mesh, group=group)
    if run.adaptive:
        return AdaptiveStreamExecutor(mesh=mesh, exec_cfg=run.cfg, device=dev)
    return StreamExecutor(tx.tx_plan(MCS, L), mesh=mesh, exec_cfg=run.cfg, device=dev)


def mesh_leg(r: Rank, run: MeshRun) -> dict:
    """One executor leg on this rank: the checked run (launches counted,
    rank 0's first kernel calls recorded), a timed warm run, ``mesh_step``
    by CUDA events; rank 0 then runs the local executor and holds the
    recorded calls."""
    ex = _make(run, r.group, r.dev)
    steps = _steps(ex, run.stream)
    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    record = r.rank == 0 and r.cuda
    r.sync()
    r.reset()
    with (cs.recording(*targets, keep=HELD) if record else contextlib.nullcontext({})) as calls:
        records = ex.run(run.stream)
    launches = r.counts()
    good = {(rec.channel, rec.rate_idx, rec.psdu.tobytes()) for rec in records if rec.parity_ok}
    n_good = sum(rec.parity_ok for rec in records)
    lost = run.sent - good
    r.check(not lost, f"{run.label}: {len(lost)} of {len(run.sent)} frames lost")
    # phases 28-29's rule: the fixed-plan legs bring back no good record
    # beyond the sent frames; the adaptive one loses none
    r.check(run.adaptive or n_good == len(run.sent),
            f"{run.label}: {n_good} good records for {len(run.sent)} frames")
    if r.cuda:
        r.check(launches["sync_detect"] == steps and launches["sync_stats"] == 0
                and launches["fir_filter"] == launches["polyphase_resample"] == 0
                and (launches["viterbi_decode"] == steps and launches["viterbi_decode_many"] > 0
                     if run.adaptive else launches["viterbi_decode_many"] == steps
                     and launches["viterbi_decode"] == 0),
                f"{run.label}: launches {launches} for {steps} steps")

    ex.tracer = Tracer()
    r.sync()
    t0 = time.perf_counter()
    ex.run(run.stream)
    r.sync()
    wall = time.perf_counter() - t0
    stages = {k: v.seconds * 1e3 for k, v in ex.tracer.report().items()}

    step_ms = None
    if r.cuda:
        wire, taus = ex.mesh_layout(run.stream, 0)
        wire = torch.from_numpy(wire).to(r.dev)
        taus = None if taus is None else torch.from_numpy(taus).to(r.dev)
        step_ms = cs.cuda_ms(lambda: ex.mesh_step(wire, taus), 5)
        del wire, taus
    per_rank = r.gather({"launches": launches, "stages_ms": stages, "digest":
                         records_digest(records)})
    # every rank collects from the same gathered outputs and runs stage B
    # replicated: equal records, equal stage-B launches
    r.check(len({p["digest"] for p in per_rank}) == 1, f"{run.label}: ranks' records differ")
    r.check(not r.cuda or len({p["launches"]["viterbi_decode_many"] for p in per_rank}) == 1,
            f"{run.label}: ranks' stage-B launches differ")
    out = {"mesh": list(run.mesh), "ranks": r.world, "block": run.cfg.block_size,
           "samples": int(run.stream.size), "steps": steps, "sent": len(run.sent),
           "good": n_good, "records_sha256": records_digest(records), "wall_s": wall,
           "mesh_step_ms": step_ms, "launches": [p["launches"] for p in per_rank],
           "stages_ms": [p["stages_ms"] for p in per_rank],
           "layout_ms_per_step": [p["stages_ms"].get("layout", 0.0) / steps for p in per_rank]}
    if r.rank == 0:
        local = _make(run, None, r.dev).run(run.stream)
        out["equal_local"] = records_digest(local) == out["records_sha256"]
        r.check(out["equal_local"], f"{run.label}: good records differ from the local "
                                    f"executor's")
        held = {}
        if record:
            for name, (e, shapes) in cs.hold_recorded(calls, run.label).items():
                held[name] = {"max_abs_err": e, "inputs": sorted({str(s) for s in shapes})}
        out["held"] = held
        del local, calls
    del ex
    if r.cuda:
        torch.cuda.empty_cache()
    return out


def train_leg(r: Rank) -> dict:
    """Two m2m steps on a data mesh over the group against the one-rank
    Trainer on rank 0 (chip_smoke.py phase 30's tolerances), every rank's
    state equal to rank 0's."""
    model = train_model(r.args, r.dev)
    batches, labels = train_batches(model.img_size, r.args.seed), pe_labels(mwt.TARGET_USERS)
    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    def two_steps(tr):
        losses = [tr.train_step(batches[0], labels, "m2m")]
        grads = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
        if r.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        losses.append(tr.train_step(batches[1], labels, "m2m"))
        if r.cuda:
            ev[1].record()
            torch.cuda.synchronize()
        return losses, grads, ev[0].elapsed_time(ev[1]) if r.cuda else None

    tr = Trainer(model, learning_rate=cs.SMALL_LR, mesh=make_data_mesh(group=r.group),
                 device=r.dev)
    r.sync()
    r.reset()
    t0 = time.perf_counter()
    losses, grads, step_ms = two_steps(tr)
    r.sync()
    wall = time.perf_counter() - t0
    launches = r.counts()
    flat = torch.cat([v.detach().reshape(-1).double() for v in model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, dist.get_global_rank(r.group, 0), group=r.group)
    n_params = sum(p.numel() for p in model.parameters())
    per_rank = r.gather({"launches": launches, "replica_equal": bool(torch.equal(flat, ref))})
    r.check(all(p["replica_equal"] for p in per_rank), "train: a rank's state differs from "
                                                       "rank 0's")
    r.check(all(v == 0 for v in launches.values()), f"train: RX kernels launched {launches}")
    state = weights._flatten(weights.flax_from_module(model))
    profile = None
    if r.cuda:
        # a third step, every rank in it (its collectives), rank 0 profiled
        def step3():
            return tr.train_step(batches[0], labels, "m2m")

        if r.rank == 0:
            wall_ms, busy, by_name, _, n_act = cs.device_profile(step3)
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
            profile = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                       "activities": n_act,
                       "top": [[name, sum(ts), len(ts)] for name, ts in top]}
        else:
            step3()
        r.sync()
    out = {"ranks": r.world, "img": int(batches.shape[-2]), "c": model.compressed_channel,
           "batch": [int(b) for b in batches.shape[1:3]], "losses": losses, "wall_s": wall,
           "warm_step_ms": step_ms, "allreduce_bytes": 4 * (n_params + 1),
           "replicas_equal": True, "launches": [p["launches"] for p in per_rank],
           "profile": profile}
    del tr, model, flat, ref
    if r.rank == 0:
        local = train_model(r.args, r.dev)
        local.load_state_dict(start)
        l_loc, g_loc, loc_ms = two_steps(Trainer(local, learning_rate=cs.SMALL_LR,
                                                    device=r.dev))
        v_loc = weights._flatten(weights.flax_from_module(local))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l_loc))
        grad_bad = [n for n in g_loc if float((grads[n] - g_loc[n]).abs().max()) > max(
            cs.SMALL_GRAD_RTOL * float(g_loc[n].abs().max()), cs.SMALL_GRAD_ATOL)]
        param_err = max(float(np.abs(state[k] - v_loc[k]).max()) for k in v_loc
                        if k.startswith("params"))
        stats_err = max((float(np.abs(state[k] - v_loc[k]).max()) for k in v_loc
                         if k.startswith("batch_stats")), default=0.0)
        out.update(local_losses=l_loc, local_warm_step_ms=loc_ms, loss_rel=loss_rel,
                   grads_out_of_tolerance=grad_bad, param_err_lr=param_err / cs.SMALL_LR,
                   stats_err=stats_err)
        r.check(loss_rel <= cs.SMALL_LOSS_RTOL and not grad_bad,
                f"train: losses {loss_rel:.3g} relative or gradients {grad_bad[:5]} off the "
                f"one-rank Trainer's")
        r.check(param_err <= 2 * 2 * cs.SMALL_LR + 1e-6 and stats_err <= cs.SMALL_STATS_ATOL,
                f"train: parameters {param_err:.3g} or statistics {stats_err:.3g} off the "
                f"one-rank Trainer's")
        del local
    if r.cuda:
        torch.cuda.empty_cache()
    return out


def _ms(v) -> str:
    return "not measured (no card)" if v is None else f"{v:.3f} ms"


def leg_line(label: str, res: dict, card: str) -> str:
    """A leg's result as one line of text."""
    if label == "train":
        return (f"train (a data mesh over {res['ranks']} rank(s), {res['img']} x {res['img']}, "
                f"c = {res['c']}, {res['batch'][0]} x {res['batch'][1]} crops): losses "
                f"{[round(v, 7) for v in res['losses']]}, one-rank Trainer's "
                f"{[round(v, 7) for v in res['local_losses']]} ({res['loss_rel']:.3g} "
                f"relative), parameters within {res['param_err_lr']:.3g} lr, statistics within "
                f"{res['stats_err']:.3g}, every rank's state equal to rank 0's; run "
                f"{res['wall_s']:.3f} s wall; warm step {_ms(res['warm_step_ms'])} (CUDA events; "
                f"the one-rank Trainer's {_ms(res['local_warm_step_ms'])}); gradient all-reduce "
                f"{res['allreduce_bytes']} bytes a step; a third step profiled on rank 0: "
                f"{json.dumps(res['profile'])} ({card})")
    per = [{k: v.get(k, 0) for k in ("sync_detect", "viterbi_decode", "viterbi_decode_many")}
           for v in res["launches"]]
    stages = [{k: round(s.get(k, 0.0), 1) for k in ("layout", "transfer", "collect")}
              for s in res["stages_ms"]]
    return (f"{label} ({res['mesh'][0]} x {res['mesh'][1]} cells of {res['block']} over "
            f"{res['ranks']} rank(s), {res['samples']} samples, {res['steps']} steps): "
            f"{res['good']} good records for {res['sent']} frames, every frame bit-exact, equal "
            f"to the local executor's: {res.get('equal_local')}; run {res['wall_s']:.3f} s wall "
            f"(warm, host clock); stages ms by rank {json.dumps(stages)}; layout ms a step by "
            f"rank {[round(v, 1) for v in res['layout_ms_per_step']]}; mesh_step "
            f"{_ms(res['mesh_step_ms'])} (CUDA events); launches by rank {json.dumps(per)}; held "
            f"{json.dumps({k: v['max_abs_err'] for k, v in res.get('held', {}).items()})} "
            f"({card})")


def worker(args) -> None:
    rank, world, port = args.worker
    dev = resolve(args.device)
    if dev.type == "cuda":
        # before any tensor, executor or model: ranks 1.. must not open card 0
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        build.library()
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        r = Rank(args, dev, dist.group.WORLD, rank, world,
                 [k1.sync_stats, k1.sync_detect, k2.viterbi_decode, k2.viterbi_decode_many,
                  k34.fir_filter, k34.polyphase_resample])
        # every rank in the group's first collective, before any halo exchange
        r.sync()
        runs = (dry_runs if args.dryrun else full_runs)(world, args.seed, dev)
        report = {}
        for run in runs:
            report[run.label] = mesh_leg(r, run)
            run.stream = None
        report["train"] = train_leg(r)
        r.sync()
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "gnuradio_wifi_imagetransfer_tpu"
                        or m.startswith("gnuradio_wifi_imagetransfer_tpu."))
        r.check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")
        if rank == 0:
            print("RESULT " + json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()


# -- the worlds -----------------------------------------------------------------


def run_world(args, world: int) -> dict:
    """Start ``world`` workers (this script's arguments), wait for all, and
    return rank 0's report; any rank that exits non-zero ends the others
    and raises with its output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+")) for _ in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:],
                                   "--worker", str(rank), str(world), port],
                                  stdout=logs[rank], stderr=subprocess.STDOUT, env=env, text=True)
                 for rank in range(world)]
        deadline = time.monotonic() + args.timeout
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        failed = [i for i, c in enumerate(codes) if c not in (0, -9)]
        detail = "\n".join(f"--- rank {i} (exit {codes[i]}):\n{outs[i][-4000:]}"
                           for i in range(world) if codes[i] != 0)
        why = (f"rank {failed[0]} failed" if failed
               else f"no rank finished within {args.timeout:g} s")
        raise RuntimeError(f"world of {world}: {why} (exits {codes}; -9: ended by this "
                           f"script)\n{detail}")
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"world of {world}: rank 0 printed no RESULT line:\n{outs[0][-3000:]}")


def main() -> None:
    args = _parse()
    if args.worker:
        worker(args)
        return
    dev = resolve(args.device)
    if dev.type == "cuda":
        if max(args.procs) > torch.cuda.device_count():
            raise RuntimeError(f"--procs {max(args.procs)} needs that many cards (one NCCL "
                               f"rank a card); this machine has {torch.cuda.device_count()}")
        build.build()                  # once, before the ranks load it
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()
        print("\n".join(card))
    else:
        card = ["cpu"]
    report = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "card": card, "backend": "nccl" if dev.type == "cuda" else "gloo",
              "shapes": "dryrun" if args.dryrun else "full", "worlds": {}, "scaling": {}}
    for world in args.procs:
        t0 = time.perf_counter()
        res = run_world(args, world)
        report["worlds"][str(world)] = res
        for label, leg in res.items():
            print(leg_line(label, leg, card[0]), flush=True)
        print(f"world of {world}: every leg passed ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    # strong scaling of the legs whose total shape stays the same over the
    # worlds (fixed-jax-layout grows with N)
    base = min(args.procs)
    for label, leg in report["worlds"][str(base)].items():
        legs = {w: report["worlds"][str(w)][label] for w in args.procs}
        if len({json.dumps([v.get("samples"), v.get("batch")]) for v in legs.values()}) == 1:
            report["scaling"][label] = {
                str(w): {"wall_s": v["wall_s"], "speedup": leg["wall_s"] / v["wall_s"],
                         "efficiency": leg["wall_s"] / v["wall_s"] * base / w}
                for w, v in legs.items()}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
