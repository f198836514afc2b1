"""The port's data-parallel trainer (utils/trainer.py with a ("data",)
mesh) across 2 gloo processes against the JAX package's
``Trainer(mesh=Mesh(devices[:2], ("data",)))`` on the CPU.

Both start from JAX's initialisation, carried into the port, and take the
same batches; each port rank is given the whole batch and keeps its half
of the per-user batch axis. Tolerances are tests/test_torch_training.py's:
losses within 1e-5 relative; gradients within 1e-4 of each leaf's largest
(or 1e-8 absolute); parameters within 0.01 lr, but within 2 lr a step for
the leaves whose gradient lies below 1e-7; batch statistics within 1e-5.
BatchNorm must normalise by the global batch, as JAX's does under pjit: a
BatchNorm with per-rank statistics is another model and fails the losses.
A per-user batch that does not split over the 2 ranks raises on each.
The workers import no JAX; each has its own 120 s timeout.
"""

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

from gnuradio_wifi_imagetransfer_tpu.models import somanet as jsomanet
from gnuradio_wifi_imagetransfer_tpu.utils import trainer as jtrainer
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt

torch.set_num_threads(2)

U, B = 2, 4
TIMEOUT = 120
REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _jax_mini():
    """tests/test_torch_training.py's miniature Flax model."""
    import flax.linen as nn

    class Mini(nn.Module):
        @nn.compact
        def __call__(self, images, labels, train=False):
            u, b = images.shape[:2]
            x = images.reshape((u * b,) + images.shape[2:])
            x = nn.Conv(8, (3, 3), use_bias=False)(x)
            x = nn.BatchNorm(use_running_average=not train)(x)
            x = nn.relu(x)
            x = nn.Conv(3, (3, 3))(x)
            return x.reshape(images.shape[:2] + x.shape[1:])

    return Mini()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(jtr) -> dict:
    return _np({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})


def _jax_dp(model, lr, img):
    mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    return jtrainer.Trainer(model, learning_rate=lr, mesh=mesh, user_num=U, img_size=img,
                            batch_size=B)


def _assert_state(got_flat, jtr, lr, params_atol_lr, noise_leaves=()):
    want = wt._flatten(_variables(jtr))
    assert got_flat.keys() == want.keys()
    for k in want:
        err = float(np.abs(got_flat[k] - want[k]).max())
        if k.startswith("batch_stats"):
            assert err <= 1e-5, (k, err)
        elif k in noise_leaves:
            assert err <= 2 * lr * jtr.state.step, (k, err / lr, "lr")
        else:
            assert err <= params_atol_lr * lr, (k, err / lr, "lr")


_WORKER = r"""
import copy, datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, job_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=90))
from gnuradio_wifi_imagetransfer_tpu_torch.models import layers
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import make_data_mesh
from gnuradio_wifi_imagetransfer_tpu_torch.utils import trainer

def _soma(job, mesh):
    from gnuradio_wifi_imagetransfer_tpu_torch.models import somanet
    model = somanet.SOMANet(job["c"], job["img"], 4, device="cpu")
    model.load_state_dict(wt.state_dict_from_flax(job["start"], model))
    tr = trainer.Trainer(model, learning_rate=job["lr"], mesh=mesh, device="cpu")
    losses = [tr.train_step(job["imgs"][0], job["labels"], mode="m2m")]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    losses.append(tr.train_step(job["imgs"][1], job["labels"], mode="m2m"))
    g = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in g.named_parameters():
            p.copy_(grads[k])
    return {"losses": losses, "grads": wt._flatten({"params": wt.flax_from_module(g)["params"]}),
            "state": wt._flatten(wt.flax_from_module(model)), "step": tr.step}


def _mini(job, mesh):
    model = PortMini()
    model.load_state_dict(wt.state_dict_from_flax(job["start"], model))
    tr = trainer.Trainer(model, learning_rate=job["lr"], mesh=mesh, device="cpu")
    images, labels = job["images"], job["labels"]
    losses = [tr.train_step(images, labels) for _ in range(2)]
    for mode in ("m2m", "distill"):
        losses += [tr.train_step(images * (1 + i), labels, mode=mode) for i in range(2)]
    losses += tr.train_steps(job["seq"], np.stack([labels] * 3)).tolist()
    bands = np.stack([images, images[::-1]])
    losses.append(tr.train_step_multiband(bands, np.stack([labels] * 2), [1.0, 2.0]))
    return {"losses": losses, "state": wt._flatten(wt.flax_from_module(model)),
            "step": tr.step}


def _uneven(job, mesh):
    # B = 3 does not split over 2 ranks: each rank raises before any step
    tr = trainer.Trainer(PortMini(), mesh=mesh, device="cpu")
    try:
        tr.train_step(np.zeros((2, 3, 8, 8, 3), np.float32), job["labels"])
    except ValueError as e:
        return {"error": str(e), "step": tr.step}
    return {"error": None, "step": tr.step}


class PortMini(torch.nn.Module):
    # tests/test_torch_training.py's miniature model

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.BatchNorm_0 = layers.BatchNorm(8)
        self.Conv_1 = torch.nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, images, labels, train=False):
        x = images.reshape((-1,) + images.shape[2:])
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return self.Conv_1(x).reshape(images.shape)


with open(job_path, "rb") as f:
    jobs = pickle.load(f)
mesh = make_data_mesh(group=dist.group.WORLD)
out = {name: {"soma": _soma, "mini": _mini, "uneven": _uneven}[name](job, mesh)
       for name, job in jobs.items()}
assert not any(m == "jax" or m.startswith(("jax.", "gnuradio_wifi_imagetransfer_tpu."))
               or m == "gnuradio_wifi_imagetransfer_tpu" for m in sys.modules)
with open(f"{job_path}.{rank}", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def _start_world(jobs, tmp: pathlib.Path) -> list[subprocess.Popen]:
    """The worker in 2 gloo processes on ``jobs``, started."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    script, job = tmp / "dp_worker.py", tmp / "jobs.pkl"
    script.write_text(_WORKER)
    job.write_bytes(pickle.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, str(script), str(r), "2", port, str(job)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(2)]


def _finish_world(procs, tmp: pathlib.Path) -> list[dict]:
    """Each rank's results once the world has ended."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [pickle.loads((tmp / f"jobs.pkl.{r}").read_bytes()) for r in range(2)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Two m2m steps of a 16 x 16, c = 16 SOMANet and the miniature model
    through every mode, JAX's data-parallel trainer against 2 gloo ranks."""
    img, c, lr = 16, 16, 1e-3
    rng = np.random.default_rng(0)
    imgs = (rng.standard_normal((2, U, B, img, img, 3)) * 0.3).astype(np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"]).astype(np.float32)
    jmodel = jsomanet.SOMANet(compressed_channel=c, img_size=img, n_irs=4)
    jsoma = _jax_dp(jmodel, lr, img)
    soma_start = _variables(jsoma)
    mlr = 3e-3
    images = (rng.standard_normal((U, B, 8, 8, 3)) * 0.3).astype(np.float32)
    seq = rng.integers(0, 256, (3, U, B, 8, 8, 3), dtype=np.uint8)
    jmini = _jax_dp(_jax_mini(), mlr, 8)
    mini_start = _variables(jmini)

    def loss_fn(params, stats, im, lb):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, im, lb, True,
                              mutable=["batch_stats"])
        return jnp.mean(jnp.mean((out - im) ** 2, axis=(1, 2, 3, 4)))

    # the port's ranks run while JAX takes its steps
    jobs = {"soma": dict(start=soma_start, imgs=imgs, labels=labels, lr=lr, c=c, img=img),
            "mini": dict(start=mini_start, images=images, labels=labels, seq=seq, lr=mlr),
            "uneven": dict(labels=labels)}
    tmp = tmp_path_factory.mktemp("dp")
    procs = _start_world(jobs, tmp)

    try:
        jgrads = _np(jax.jit(jax.grad(loss_fn))(soma_start["params"], soma_start["batch_stats"],
                                                imgs[0], labels))
        soma_losses = [jsoma.train_step(imgs[i], labels, mode="m2m") for i in range(2)]

        mini_losses = [jmini.train_step(images, labels) for _ in range(2)]
        for mode in ("m2m", "distill"):
            mini_losses += [jmini.train_step(images * (1 + i), labels, mode=mode)
                            for i in range(2)]
        mini_losses += np.asarray(jmini.train_steps(seq, np.stack([labels] * 3))).tolist()
        bands = np.stack([images, images[::-1]])
        mini_losses.append(jmini.train_step_multiband(bands, np.stack([labels] * 2), [1.0, 2.0]))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = _finish_world(procs, tmp)
    return dict(ranks=ranks, jsoma=jsoma, jgrads=jgrads, soma_losses=soma_losses, lr=lr,
                jmini=jmini, mini_losses=mini_losses, mlr=mlr)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_m2m_steps_across_two_ranks_match_jax(dp, rank):
    """SOMANet, B = 4 split 2 + 2: the global losses, the first step's
    all-reduced gradients, then every parameter and batch statistic."""
    got = dp["ranks"][rank]["soma"]
    np.testing.assert_allclose(got["losses"], dp["soma_losses"], rtol=1e-5)
    want = wt._flatten({"params": dp["jgrads"]})
    for k in want:
        err = float(np.abs(got["grads"][k] - want[k]).max())
        assert err <= max(1e-4 * float(np.abs(want[k]).max()), 1e-8), (k, err)
    small = {k for k in want if float(np.abs(want[k]).max()) < 1e-7}
    _assert_state(got["state"], dp["jsoma"], dp["lr"], 0.01, small)
    assert got["step"] == dp["jsoma"].state.step == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_every_mode_across_two_ranks_matches_jax(dp, rank):
    """The miniature model through 'default', 'm2m', 'distill',
    train_steps on uint8 batches and 'multi-band', data-parallel."""
    got = dp["ranks"][rank]["mini"]
    np.testing.assert_allclose(got["losses"], dp["mini_losses"], rtol=1e-5)
    _assert_state(got["state"], dp["jmini"], dp["mlr"], 0.01)
    assert got["step"] == dp["jmini"].state.step == 2 + 4 + 3 + 1


def test_ranks_hold_equal_replicas(dp):
    a, b = (dp["ranks"][r]["soma"]["state"] for r in (0, 1))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_batch_that_does_not_split_over_the_ranks_raises(dp):
    """B = 3 over 2 ranks: every rank raises ValueError before its first
    step (JAX's pjit refuses the uneven shard too)."""
    for out in dp["ranks"]:
        assert "does not split evenly" in out["uneven"]["error"]
        assert out["uneven"]["step"] == 0
