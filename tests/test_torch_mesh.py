"""The port's (channel, time) mesh (parallel/mesh.py and the mesh mode of
parallel/executor.py) against the JAX package's mesh on the CPU.

In-process twins (``group=None``: every cell on this process) of the
JAX package's mesh tests, JAX running its mesh on 8 virtual CPU devices:
tests/test_executor.py:81-165, tests/test_adaptive_executor.py:64-146 and
the mesh cases of tests/test_frontend.py:207-272. Then gloo worlds of 2
and 4 processes (``tcp://127.0.0.1:<free port>``), whose workers import
no JAX, on streams where frames straddle the boundaries between ranks:
every rank must return JAX's single-process mesh records. Last, an
executor with ``mesh=None`` inside a group of 2 runs without touching
the group.

Records are compared by tests/test_torch_equalizer.py's rule: channel,
global_start, parity_ok, rate_idx, length and psdu exactly; cfo within
1e-5 rad/sample, snr_db within 1e-3 dB (float32 statistics of two
libraries). Every subprocess has its own 120 s timeout.
"""

import functools
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.channel.model import sample_clock_offset
from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveStreamExecutor as JAdaptive
from gnuradio_wifi_imagetransfer_tpu.parallel import StreamExecutor as JStream
from gnuradio_wifi_imagetransfer_tpu.parallel import make_mesh as jmake_mesh
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, FrontendConfig
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveStreamExecutor,
    FrameRecord,
    StreamExecutor,
    make_mesh,
)
from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

torch.set_num_threads(2)

MCS, L = 2, 50
TIMEOUT = 120
REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _records_equal(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.parity_ok, g.rate_idx, g.length) == (
            w.channel, w.global_start, w.parity_ok, w.rate_idx, w.length)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3


def _recovered(records, sent):
    """Every (channel, position, payload) of ``sent`` comes back once with
    parity good, its edge within 160 samples of the burst's start."""
    ok = [r for r in records if r.parity_ok]
    for ch, pos, payload in sent:
        hits = [r for r in ok if r.channel == ch and np.array_equal(r.psdu, payload)]
        assert len(hits) == 1, (ch, pos, len(hits))
        assert abs(hits[0].global_start - pos) <= 160, (hits[0].global_start, pos)


# -- streams (the JAX tests' fixtures; the JAX package's TX makes the bursts) ---


def _fixed_stream(n, positions, frames, seed, snr_db=25):
    rng = np.random.default_rng(seed)
    bursts = np.asarray(jtx.transmit(jnp.asarray(frames), MCS,
                                     scrambler_seed=jnp.asarray(np.arange(len(frames)) % 127 + 1)))
    x = np.zeros(n, np.complex64)
    for pos, b in zip(positions, bursts):
        x[pos: pos + b.size] += 0.5 * b
    noise = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    return (x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def _mixed_stream(n, specs, seed, snr_db=30):
    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.complex64)
    for i, (pos, mcs, payload) in enumerate(specs):
        b = np.asarray(jtx.transmit(jnp.asarray(payload)[None], mcs,
                                    scrambler_seed=(i % 127) + 1))[0]
        x[pos: pos + b.size] += 0.5 * b
    noise = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    return (x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def _payloads():
    return np.random.default_rng(42).integers(0, 256, (6, L), dtype=np.uint8)


def _fft_oversample(x, m):
    n = len(x)
    spec = np.fft.fft(x)
    up = np.zeros(m * n, np.complex64)
    up[: n // 2], up[-(n // 2):] = spec[: n // 2], spec[-(n // 2):]
    return (np.fft.ifft(up) * m).astype(np.complex64)


def _frontend_stream(seed, n=120_000, n_frames=6, noise=0.012):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, 50), dtype=np.uint8)
    bursts = np.asarray(jtx.transmit(frames, MCS))
    x = (noise * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    starts = [4000 + i * ((n - 8000) // n_frames) for i in range(n_frames)]
    for i, s in enumerate(starts):
        x[s: s + bursts.shape[1]] += bursts[i]
    return x, [(0, s, f) for s, f in zip(starts, frames)]


@functools.lru_cache(maxsize=None)
def _scenario(name):
    """name -> (kind, stream (C, n), ExecutorConfig keywords, FrontendConfig
    keywords or None, mesh (channels, time), sent frames or None). The
    positions put frames across block, rank and super-block seams."""
    p = _payloads()
    if name.startswith("fixed-"):                  # test_executor.py:81-110
        c, t = map(int, name[6:].split("x"))
        n = t * 4096
        rows, sent = [], []
        for ci in range(c):
            frames = p[(2 * ci) % 6: (2 * ci) % 6 + 2]
            pos = [600 + 900 * ci, n // 2 + 350 * ci]
            rows.append(_fixed_stream(n, pos, frames, seed=10 + ci))
            sent += [(ci, q, f) for q, f in zip(pos, frames)]
        return ("fixed", np.stack(rows), dict(block_size=4096, time_shards=t,
                max_frames_per_block=4, channels=c), None, (c, t), sent)
    if name == "straddle":                          # test_executor.py:113-123
        pos = [2048 - 400, 3 * 2048 - 900, 6 * 2048 - 1200]
        x = _fixed_stream(8 * 2048, pos, p[:3], seed=5)
        return ("fixed", x[None], dict(block_size=2048, time_shards=8, max_frames_per_block=4),
                None, (1, 8), [(0, q, f) for q, f in zip(pos, p[:3])])
    if name.startswith("stream-end-"):              # test_executor.py:126-151
        t = int(name[11:])
        burst = np.asarray(jtx.transmit(jnp.asarray(p[:1]), MCS,
                                        scrambler_seed=jnp.asarray([1])))[0]
        n = 4 * 2048
        x = np.zeros(n, np.complex64)
        x[n - burst.size:] += 0.5 * burst
        rng = np.random.default_rng(11)
        x += (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
        return ("fixed", x[None], dict(block_size=2048, time_shards=t, max_frames_per_block=4),
                None, (1, t), [(0, n - burst.size, p[0])])
    if name == "gloo-fixed":
        # three super-block strides; frames straddle the rank seams of
        # worlds of 2 and 4 (4 096, 8 192, 12 288 past a stride's offset)
        n = 3 * 4 * 4096
        pos = [600, 4096 - 500, 8192 - 300, 12288 - 700, 16000, 24000, 31000, 38000, 45500]
        rng = np.random.default_rng(8)
        rows, sent = [], []
        for ci in range(2):
            frames = rng.integers(0, 256, (len(pos), L), dtype=np.uint8)
            q = [v + 350 * ci for v in pos]
            rows.append(_fixed_stream(n, q, frames, seed=20 + ci))
            sent += [(ci, v, f) for v, f in zip(q, frames)]
        return ("fixed", np.stack(rows), dict(block_size=4096, time_shards=4,
                max_frames_per_block=4, channels=2), None, (2, 4), sent)
    if name == "adaptive-straddle":                 # test_adaptive_executor.py:64-82
        rng = np.random.default_rng(3)
        specs = [(2048 - 400, 0, rng.integers(0, 256, 50, dtype=np.uint8)),
                 (3 * 2048 + 500, 3, rng.integers(0, 256, 120, dtype=np.uint8)),
                 (6 * 2048 - 200, 7, rng.integers(0, 256, 80, dtype=np.uint8))]
        return ("adaptive", _mixed_stream(8 * 2048, specs, seed=5)[None],
                dict(block_size=2048, time_shards=8, max_frames_per_block=4), None, (1, 8),
                [(0, q, f) for q, _, f in specs])
    if name == "adaptive-2x4":                      # test_adaptive_executor.py:85-108
        rng = np.random.default_rng(7)
        specs_a = [(600, 0, rng.integers(0, 256, 50, dtype=np.uint8)),
                   (4000, 3, rng.integers(0, 256, 120, dtype=np.uint8)),
                   (7000, 7, rng.integers(0, 256, 50, dtype=np.uint8)),
                   (10500, 3, rng.integers(0, 256, 50, dtype=np.uint8))]
        rng = np.random.default_rng(11)
        specs_b = [(1500, 7, rng.integers(0, 256, 200, dtype=np.uint8)),
                   (9000, 0, rng.integers(0, 256, 50, dtype=np.uint8))]
        x = np.stack([_mixed_stream(4 * 4096, specs_a, seed=1),
                      _mixed_stream(4 * 4096, specs_b, seed=2)])
        sent = [(0, q, f) for q, _, f in specs_a] + [(1, q, f) for q, _, f in specs_b]
        return ("adaptive", x, dict(block_size=4096, time_shards=4, max_frames_per_block=4,
                channels=2), None, (2, 4), sent)
    if name == "adaptive-superblock":               # test_adaptive_executor.py:111-128
        span = 2 * 2048
        rng = np.random.default_rng(9)
        specs = [(span - 700, 3, rng.integers(0, 256, 60, dtype=np.uint8)),
                 (2 * span + 300, 7, rng.integers(0, 256, 60, dtype=np.uint8))]
        return ("adaptive", _mixed_stream(3 * span, specs, seed=4)[None],
                dict(block_size=2048, time_shards=2, max_frames_per_block=4), None, (1, 2),
                [(0, q, f) for q, _, f in specs])
    if name == "adaptive-stream-end":               # test_adaptive_executor.py:131-146
        rng = np.random.default_rng(21)
        payload = rng.integers(0, 256, 60, dtype=np.uint8)
        burst = np.asarray(jtx.transmit(jnp.asarray(payload)[None], 3))[0]
        n = 4 * 2048
        x = np.zeros(n, np.complex64)
        x[n - burst.size:] += 0.5 * burst
        x += (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
        return ("adaptive", x[None], dict(block_size=2048, time_shards=4, max_frames_per_block=4),
                None, (1, 4), [(0, n - burst.size, payload)])
    # front-end mesh cases (test_frontend.py:207-272): a (1, 4) mesh, block
    # 2**14, the host cutting input-rate windows
    kind, fe = name.split("-", 2)[1:]
    x, sent = _frontend_stream({"2x": 7, "ppm+40": 11, "ppm-40": 17, "2x-ppm": 19}[fe])
    if fe.startswith("2x"):
        x = _fft_oversample(x, 2)
    if fe.startswith("ppm") or fe == "2x-ppm":
        ppm = {"ppm+40": 40.0, "ppm-40": -40.0, "2x-ppm": -25.0}[fe]
        x = np.asarray(sample_clock_offset(jnp.asarray(x), ppm))
    fe_kw = {"2x": dict(resample=(1, 2)), "ppm+40": dict(ppm=40.0), "ppm-40": dict(ppm=-40.0),
             "2x-ppm": dict(resample=(1, 2), ppm=-25.0)}[fe]
    return (kind, x[None], dict(block_size=1 << 14, time_shards=2), fe_kw, (1, 4), sent)


@functools.lru_cache(maxsize=None)
def _jax_records(name):
    """JAX's mesh records of a scenario on its virtual CPU devices."""
    kind, x, cfg_kw, fe_kw, (c, t), _ = _scenario(name)
    cfg = jconfig.ExecutorConfig(
        frontend=None if fe_kw is None else jconfig.FrontendConfig(**fe_kw), **cfg_kw)
    mesh = (JMesh(np.array(jax.devices()[: c * t]).reshape(c, t), ("channel", "time"))
            if fe_kw is not None else jmake_mesh(channels=c, time_shards=t))
    if kind == "fixed":
        return JStream(jtx.tx_plan(MCS, L), mesh=mesh, exec_cfg=cfg).run(x)
    return JAdaptive(mesh=mesh, exec_cfg=cfg).run(x)


def _port(kind, cfg_kw, fe_kw, mesh):
    cfg = ExecutorConfig(frontend=None if fe_kw is None else FrontendConfig(**fe_kw), **cfg_kw)
    if kind == "fixed":
        return StreamExecutor(tx.tx_plan(MCS, L), mesh=mesh, exec_cfg=cfg, device="cpu")
    return AdaptiveStreamExecutor(mesh=mesh, exec_cfg=cfg, device="cpu")


# -- in-process twins (group=None) ------------------------------------------------

IN_PROCESS = ["fixed-1x8", "fixed-2x4", "fixed-4x2", "straddle", "stream-end-4", "stream-end-1",
              "adaptive-straddle", "adaptive-2x4", "adaptive-superblock", "adaptive-stream-end",
              "frontend-fixed-2x", "frontend-fixed-ppm+40", "frontend-fixed-ppm-40",
              "frontend-adaptive-2x", "frontend-adaptive-ppm-40"]


@pytest.mark.parametrize("name", IN_PROCESS)
def test_mesh_matches_jax(name):
    """The port's mesh on one process gives JAX's mesh records and brings
    every sent frame back once; without a front-end, its parity-good
    records equal the port's local executor's (test_executor.py:81-110)."""
    kind, x, cfg_kw, fe_kw, (c, t), sent = _scenario(name)
    got = _port(kind, cfg_kw, fe_kw, make_mesh(channels=c, time_shards=t)).run(x)
    _records_equal(got, _jax_records(name))
    _recovered(got, sent)
    if fe_kw is None:
        local = _port(kind, cfg_kw, None, None).run(x)
        assert ({(r.channel, r.global_start, r.psdu.tobytes()) for r in got if r.parity_ok}
                == {(r.channel, r.global_start, r.psdu.tobytes()) for r in local if r.parity_ok})


def test_make_mesh_matches_jax_shapes_and_errors():
    """make_mesh's shapes and ValueErrors are JAX's, ranks for devices."""
    assert make_mesh(2, 4).shape == dict(jmake_mesh(2, 4).shape) == {"channel": 2, "time": 4}
    assert make_mesh().shape == {"channel": 1, "time": 1}
    m = make_mesh(2, 4)
    assert m.local == (slice(0, 2), slice(0, 4))
    assert m.neighbour("time", -1) is None and m.neighbour("time", +1) is None
    with pytest.raises(ValueError, match="not divisible by 2 channels"):
        make_mesh(channels=2)                      # one rank, two channels
    with pytest.raises(ValueError, match="not divisible by 3 channels"):
        jmake_mesh(channels=3)                     # 8 devices, three channels


# -- gloo worlds of 2 and 4 processes -----------------------------------------------

_WORKER = r"""
import datetime, os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, job_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=90))
from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, FrontendConfig
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveStreamExecutor, StreamExecutor, make_mesh)
from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

with open(job_path, "rb") as f:
    jobs = pickle.load(f)
out = {}
for name, (kind, x, cfg_kw, fe_kw, shape) in jobs.items():
    cfg = ExecutorConfig(frontend=None if fe_kw is None else FrontendConfig(**fe_kw), **cfg_kw)
    if shape is None:
        # mesh=None inside the group: each rank its own stream, of its own
        # length, and no collective between the ranks until the barrier
        mesh, x = None, x[rank]
    else:
        mesh = make_mesh(*shape, group=dist.group.WORLD)
    if kind == "fixed":
        ex = StreamExecutor(tx.tx_plan(2, 50), mesh=mesh, exec_cfg=cfg, device="cpu")
    else:
        ex = AdaptiveStreamExecutor(mesh=mesh, exec_cfg=cfg, device="cpu")
    out[name] = [(r.channel, r.global_start, r.parity_ok, r.rate_idx, r.length, r.psdu,
                  r.cfo, r.snr_db) for r in ex.run(x)]
dist.barrier()
assert not any(m == "jax" or m.startswith(("jax.", "gnuradio_wifi_imagetransfer_tpu."))
               or m == "gnuradio_wifi_imagetransfer_tpu" for m in sys.modules)
with open(f"{job_path}.{rank}", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""

GLOO = ["gloo-fixed", "adaptive-2x4", "frontend-fixed-2x-ppm", "frontend-adaptive-2x-ppm"]


def run_world(world: int, jobs: dict, tmp: pathlib.Path) -> list[dict]:
    """Run the worker in ``world`` gloo processes on ``jobs`` ({name: (kind,
    stream, ExecutorConfig keywords, FrontendConfig keywords, mesh shape or
    None)}); returns each rank's {name: records as tuples}."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script, job = tmp / "mesh_worker.py", tmp / f"jobs{world}.pkl"
    script.write_text(_WORKER)
    job.write_bytes(pickle.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, str(job)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out[-3000:]}"
    return [pickle.loads((tmp / f"jobs{world}.pkl.{r}").read_bytes()) for r in range(world)]


def _local_job():
    """mesh=None inside the group: rank r decodes streams[r] alone, the
    streams of different lengths so the ranks take different numbers of
    steps."""
    p = _payloads()
    streams = [_fixed_stream(2 * 4096, [700], p[:1], seed=31)[None],
               _fixed_stream(5 * 4096, [900, 9000, 15000], p[1:4], seed=32)[None]]
    return ("fixed", streams, dict(block_size=4096, time_shards=1, max_frames_per_block=4),
            None, None)


@functools.lru_cache(maxsize=None)
def _gloo_world(world, tmp):
    """The GLOO scenarios in a gloo world (the world of 2 runs the local
    job last, each rank on its own stream)."""
    jobs = {name: _scenario(name)[:5] for name in GLOO}
    if world == 2:
        jobs["local"] = _local_job()
    return run_world(world, jobs, pathlib.Path(tmp))


@pytest.fixture(scope="module")
def gloo_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gloo"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", GLOO)
def test_gloo_world_matches_jax(world, name, gloo_tmp):
    """Every rank of a gloo world returns JAX's single-process mesh records;
    frames straddle the seams between ranks (the halo crosses processes)."""
    ranks = _gloo_world(world, gloo_tmp)
    want = _jax_records(name)
    for r, out in enumerate(ranks):
        got = out[name]
        assert len(got) == len(want), (r, len(got), len(want))
        for g, w in zip(got, want):
            assert g[:5] == (w.channel, w.global_start, w.parity_ok, w.rate_idx, w.length), r
            assert np.array_equal(g[5], w.psdu), r
            assert abs(g[6] - w.cfo) <= 1e-5 and abs(g[7] - w.snr_db) <= 1e-3, r
    _recovered([FrameRecord(channel=g[0], global_start=g[1], psdu=g[5], parity_ok=g[2],
                            rate_idx=g[3], length=g[4], cfo=g[6], snr_db=g[7])
                for g in ranks[0][name]], _scenario(name)[5])


def test_local_executor_in_a_group_never_calls_it(gloo_tmp):
    """mesh=None inside a gloo group of 2: each rank decodes its own stream
    (of another length, so the ranks take different numbers of steps) and
    gets the records of the same executor run alone; a collective inside
    would mismatch or hang until the timeout."""
    kind, streams, cfg_kw, _, _ = _local_job()
    ranks = _gloo_world(2, gloo_tmp)
    for r, out in enumerate(ranks):
        want = _port(kind, cfg_kw, None, None).run(streams[r])
        assert len(want) == len(out["local"]) == [1, 3][r]
        for g, w in zip(out["local"], want):
            assert g[:5] == (w.channel, w.global_start, w.parity_ok, w.rate_idx, w.length)
            assert np.array_equal(g[5], w.psdu)
