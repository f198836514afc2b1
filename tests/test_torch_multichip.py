"""multichip_torch.py, the port's counterpart of
``__graft_entry__.dryrun_multichip``, in gloo worlds of 2 and 4 processes
on the CPU, against the JAX package on its 8 virtual CPU devices.

The script runs ``--dryrun``: JAX's dry-run shapes (blocks of 4 096, 2
frames a channel, ``SOMANet(compressed_channel=32, img_size=16,
n_irs=4)`` with 8 crops a user) on JAX's layout ``make_mesh(2 if N is
even else 1)``, so at 2 ranks each rank owns one channel (channels split
over ranks) and at 4 a (channel, time) cell. The test builds the same
numpy streams with the script's own recipes (``__graft_entry__``'s, the
port's TX) and feeds them to JAX's mesh executors on the same mesh shape,
and starts JAX's data-parallel Trainer from the variables the script's
train leg is given. Required: every frame JAX's dry run asserts, the good
records equal to JAX's (channel, global_start, rate and psdu, exactly),
both losses within 1e-5 relative of JAX's, every rank's parameters equal.
The script has its own 100 s limit a world; the workers pin torch to one
thread. Last, ``--device cuda`` on a machine without a card raises.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.models import somanet as jsomanet
from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveStreamExecutor as JAdaptive
from gnuradio_wifi_imagetransfer_tpu.parallel import StreamExecutor as JStream
from gnuradio_wifi_imagetransfer_tpu.parallel import make_mesh as jmake_mesh
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu.utils import trainer as jtrainer
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import IMAGENET_MEAN, IMAGENET_STD

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import multichip_torch as mc  # noqa: E402

torch.set_num_threads(2)

WORLDS = (2, 4)
LEGS = ("fixed", "adaptive", "frontend")
ENV = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _jax_records(run: "mc.MeshRun"):
    """JAX's mesh records of one of the script's executor legs, on the
    same mesh shape over the first c x t virtual devices."""
    c, t = run.mesh
    fe = run.cfg.frontend
    cfg = jconfig.ExecutorConfig(
        block_size=run.cfg.block_size, time_shards=t, channels=run.cfg.channels,
        max_frames_per_block=run.cfg.max_frames_per_block,
        frontend=None if fe is None else jconfig.FrontendConfig(resample=fe.resample, ppm=fe.ppm))
    mesh = jmake_mesh(channels=c, time_shards=t, devices=jax.devices()[: c * t])
    if run.adaptive:
        return JAdaptive(mesh=mesh, exec_cfg=cfg).run(run.stream)
    return JStream(jtx.tx_plan(mc.MCS, mc.L), mesh=mesh, exec_cfg=cfg).run(run.stream)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The script in gloo worlds of 2 and 4 beside JAX's runs of its legs."""
    tmp = tmp_path_factory.mktemp("multichip")
    img, c, n_irs = mc.DRY_TRAIN
    lr = 1e-3
    jtr = jtrainer.Trainer(jsomanet.SOMANet(compressed_channel=c, img_size=img, n_irs=n_irs),
                           learning_rate=lr, mesh=JMesh(np.array(jax.devices()[:4]), ("data",)),
                           user_num=2, img_size=img, batch_size=mc.TRAIN_BATCH)
    start = jax.tree_util.tree_map(np.asarray, {"params": jtr.state.params,
                                                "batch_stats": jtr.state.batch_stats})
    wt.save_soma_npz(start, tmp / "start.npz", dtype=np.float32)
    out = tmp / "multichip.json"
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "multichip_torch.py"), "--device", "cpu", "--dryrun",
         "--procs", *map(str, WORLDS), "--train-npz", str(tmp / "start.npz"), "--timeout",
         "100", "--out", str(out)],
        cwd=tmp, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        jax_runs = {w: {run.label: (run, _jax_records(run)) for run in mc.dry_runs(w, 0, "cpu")}
                    for w in WORLDS}
        batches = mc.train_batches(img, 0).astype(np.float32) / 255.0
        batches = ((batches - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        labels = jsomanet.pe_labels(["3-4", "13-10"])
        jax_losses = [jtr.train_step(b, labels, mode="m2m") for b in batches]
        stdout = proc.communicate(timeout=240)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, stdout[-4000:]
    report = json.loads(stdout.strip().splitlines()[-1])
    assert report == json.loads(out.read_text())
    return dict(report=report, jax_runs=jax_runs, jax_losses=jax_losses)


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("world", WORLDS)
def test_executor_leg_matches_jax(dry, world, leg):
    """Every frame of the leg back at its rate (JAX's dry run asserts the
    same frames of JAX's records), and the good records JAX's, exactly."""
    run, jrecs = dry["jax_runs"][world][leg]
    got = dry["report"]["worlds"][str(world)][leg]
    jgood = {(r.channel, r.rate_idx, np.asarray(r.psdu).tobytes()) for r in jrecs if r.parity_ok}
    assert run.sent <= jgood and len(run.sent) == 2 * mc.DRY_CHANNELS
    assert got["mesh"] == list(mc.jax_layout(world)) and got["ranks"] == world
    assert got["sent"] == len(run.sent) and got["good"] == len(run.sent)
    assert got["equal_local"] is True
    assert got["records_sha256"] == mc.records_digest(jrecs)


def test_channels_split_over_ranks(dry):
    """At 2 ranks JAX's layout is (2, 1): each rank owns one channel cell
    and has no time neighbour, so the ranks meet only in the gather; at 4
    it is (2, 2), a halo exchange between each pair."""
    assert dry["report"]["worlds"]["2"]["fixed"]["mesh"] == [2, 1]
    assert dry["report"]["worlds"]["4"]["fixed"]["mesh"] == [2, 2]


@pytest.mark.parametrize("world", WORLDS)
def test_train_leg_matches_jax(dry, world):
    """Two m2m steps on a data mesh of ``world`` gloo ranks from JAX's
    initial variables: both losses within 1e-5 relative of JAX's Trainer on
    its ("data",) mesh, within SMALL_* of the one-rank Trainer, and every
    rank's state equal to rank 0's."""
    got = dry["report"]["worlds"][str(world)]["train"]
    np.testing.assert_allclose(got["losses"], dry["jax_losses"], rtol=1e-5)
    assert got["replicas_equal"] is True and got["ranks"] == world
    assert got["batch"] == [2, mc.TRAIN_BATCH] and got["img"] == mc.DRY_TRAIN[0]
    assert got["loss_rel"] <= 1e-4 and got["grads_out_of_tolerance"] == []


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda (the default) where torch sees no card: the script
    raises before it starts a rank and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(REPO / "multichip_torch.py"), "--procs", "1",
                        "--dryrun", "--out", str(tmp_path / "x.json")], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0
    assert "CUDA was requested" in r.stderr
    assert not (tmp_path / "x.json").exists()
