"""The port's trainer (utils/trainer.py) against the JAX package's, on the CPU.

Both trainers start from the same variables (JAX's initialisation carried
into the port) and take the same batches. Adam's first step sends every
leaf by about lr whatever the size of its gradient, so a leaf whose
gradient is near 0 may land up to 2 lr away between two float32 paths:
gradients are compared first, tightly, and parameters then within a
tolerance in units of lr. Tolerances: losses within 1e-5 relative;
gradients within 1e-4 of each leaf's largest (or 1e-8 absolute);
parameters within 0.01 lr on SOMANet (measured 0.0014 lr), but within 2
lr a step for the leaves whose gradient lies below 1e-7 (a conv bias
before BatchNorm, GDN gammas at their bound), and within 0.01 lr on the
miniature model over 13 steps (measured 0.0002 lr); batch statistics
within 1e-5.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import somanet as jsomanet
from gnuradio_wifi_imagetransfer_tpu.utils import trainer as jtrainer
from gnuradio_wifi_imagetransfer_tpu_torch.models import layers, somanet
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import make_mesh
from gnuradio_wifi_imagetransfer_tpu_torch.utils import trainer

torch.set_num_threads(2)

U, B = 2, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(jtr) -> dict:
    return _np({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})


def _assert_state(port_model, jtr, lr, params_atol_lr, noise_leaves=()):
    """Batch statistics within 1e-5; parameters within params_atol_lr lr,
    but those of ``noise_leaves`` within 2 lr a step taken."""
    got = wt._flatten(wt.flax_from_module(port_model))
    want = wt._flatten(_variables(jtr))
    assert got.keys() == want.keys()
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        if k.startswith("batch_stats"):
            assert err <= 1e-5, (k, err)
        elif k in noise_leaves:
            assert err <= 2 * lr * jtr.state.step, (k, err / lr, "lr")
        else:
            assert err <= params_atol_lr * lr, (k, err / lr, "lr")


# -- SOMANet: two m2m steps -------------------------------------------------------


def test_two_m2m_steps_match_jax():
    """A 16 x 16, c = 16 SOMANet: the gradient of the first m2m loss, the
    losses of two steps, then every parameter and batch_stats leaf."""
    img, c, lr = 16, 16, 1e-3
    rng = np.random.default_rng(0)
    imgs = (rng.standard_normal((2, U, B, img, img, 3)) * 0.3).astype(np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"]).astype(np.float32)
    jmodel = jsomanet.SOMANet(compressed_channel=c, img_size=img, n_irs=4)
    jtr = jtrainer.Trainer(jmodel, learning_rate=lr, user_num=U, img_size=img, batch_size=B)
    start = _variables(jtr)

    def loss_fn(params, stats, im, lb):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, im, lb, True,
                              mutable=["batch_stats"])
        return jnp.mean(jnp.mean((out - im) ** 2, axis=(1, 2, 3, 4)))

    jgrads = _np(jax.jit(jax.grad(loss_fn))(start["params"], start["batch_stats"],
                                            imgs[0], labels))
    jlosses = [jtr.train_step(imgs[i], labels, mode="m2m") for i in range(2)]

    model = somanet.SOMANet(c, img, 4, device="cpu")
    model.load_state_dict(wt.state_dict_from_flax(start, model))
    tr = trainer.Trainer(model, learning_rate=lr, device="cpu")
    losses = [tr.train_step(imgs[0], labels, mode="m2m")]
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for (_, g), p in zip(model.named_parameters(), grads.parameters()):
            p.copy_(g.grad)
    losses.append(tr.train_step(imgs[1], labels, mode="m2m"))

    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = wt._flatten({"params": wt.flax_from_module(grads)["params"]})
    want = wt._flatten({"params": jgrads})
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= max(1e-4 * float(np.abs(want[k]).max()), 1e-8), (k, err)
    assert float(np.abs(want["params/shared_phi"]).max()) == 0.0      # unused by forward
    # leaves whose whole gradient lies below 1e-7 (a conv bias before
    # BatchNorm, the GDN gammas at their bound): Adam's eps (1e-8) is no
    # longer small beside it, so rounding moves their update
    small = {k for k in want if float(np.abs(want[k]).max()) < 1e-7}
    _assert_state(model, jtr, lr, 0.01, small)
    assert tr.step == jtr.state.step == 2 and tr.count == 2


# -- the miniature model in every mode ----------------------------------------------


class PortMini(torch.nn.Module):
    """tests/test_training.py's Mini: Conv(8, 3x3) -> BatchNorm -> ReLU ->
    Conv(3, 3x3) over the users' images, NCHW. Its first conv has no bias
    here (nor in the JAX twin): BatchNorm takes the mean out after it, so
    the bias's gradient is rounding noise, which Adam scales up to steps
    of lr of either sign, two packages' noise apart (measured 3 lr after 4
    steps), and the running mean and every eval-mode output (the
    distillation teacher's) follow it."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.BatchNorm_0 = layers.BatchNorm(8)
        self.Conv_1 = torch.nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, images, labels, train=False):
        x = images.reshape((-1,) + images.shape[2:])
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return self.Conv_1(x).reshape(images.shape)


def _jax_mini():
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


def test_trainer_modes_on_a_miniature_model_match_jax(tmp_path):
    """The twin of tests/test_training.py test_trainer_mechanics_fast, step
    for step against JAX's trainer: 'default' x 4, 'm2m' x 2, 'distill' x 2
    (the teacher a snapshot of the student), train_steps over 3 uint8
    batches normalised on the device, 'multi-band' x 2 with weights (1, 2);
    then save / restore."""
    lr = 3e-3
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((U, B, 8, 8, 3)) * 0.3).astype(np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"]).astype(np.float32)
    jtr = jtrainer.Trainer(_jax_mini(), learning_rate=lr, user_num=U, img_size=8, batch_size=B)
    model = PortMini()
    model.load_state_dict(wt.state_dict_from_flax(_variables(jtr), model))
    tr = trainer.Trainer(model, learning_rate=lr, device="cpu")
    before = wt._flatten(wt.flax_from_module(model)["batch_stats"])

    got = [tr.train_step(images, labels) for _ in range(4)]
    want = [jtr.train_step(images, labels) for _ in range(4)]
    assert got[-1] < got[0], got
    assert any(not np.allclose(before[k], v) for k, v in
               wt._flatten(wt.flax_from_module(model)["batch_stats"]).items())
    for mode in ("m2m", "distill"):
        got += [tr.train_step(images * (1 + i), labels, mode=mode) for i in range(2)]
        want += [jtr.train_step(images * (1 + i), labels, mode=mode) for i in range(2)]
    teacher = [p.detach().clone() for p in tr.teacher.parameters()]
    seq = rng.integers(0, 256, (3, U, B, 8, 8, 3), dtype=np.uint8)
    seq_labels = np.stack([labels] * 3)
    got += tr.train_steps(seq, seq_labels).tolist()
    want += np.asarray(jtr.train_steps(seq, seq_labels)).tolist()
    bands = np.stack([images, images[::-1]])
    got += [tr.train_step_multiband(bands, np.stack([labels] * 2), [1.0, 2.0]) for _ in range(2)]
    want += [jtr.train_step_multiband(bands, np.stack([labels] * 2), [1.0, 2.0])
             for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_state(model, jtr, lr, 0.01)
    assert tr.step == jtr.state.step == 4 + 2 + 2 + 3 + 2
    assert all(torch.equal(a, b) for a, b in zip(teacher, tr.teacher.parameters()))

    path = str(tmp_path / "ckpt.pt")
    tr.save(path)
    tr2 = trainer.Trainer(PortMini(), learning_rate=lr, device="cpu")
    tr2.restore(path)
    assert tr2.step == tr.step
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 tr2.model.state_dict().values()))


def test_losses_match_jax():
    """The loss functions outside the trainer, on the miniature model."""
    rng = np.random.default_rng(4)
    images = (rng.standard_normal((U, B, 8, 8, 3)) * 0.3).astype(np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"]).astype(np.float32)
    jmodel = _jax_mini()
    variables = _np(jmodel.init(jax.random.key(1), images, labels))
    model = PortMini()
    model.load_state_dict(wt.state_dict_from_flax(variables, model))
    teacher = PortMini()
    tvars = jax.tree_util.tree_map(lambda v: v * 0.9, variables)
    teacher.load_state_dict(wt.state_dict_from_flax(tvars, teacher))
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(images, -1, -3)))
    lb = torch.from_numpy(labels)
    with torch.no_grad():
        pairs = [
            (trainer.mse_loss(model, x, lb), jtrainer.mse_loss(jmodel, variables, images, labels)),
            (trainer.m2m_loss(model, x, lb), jtrainer.m2m_loss(jmodel, variables, images, labels)),
            (trainer.distill_loss(model, teacher, x, lb, 0.3),
             jtrainer.distill_loss(jmodel, variables, tvars, images, labels, 0.3)),
            (trainer.multiband_loss(model, {5: x, 6: 2 * x}, {5: lb, 6: lb}, {5: 1.0, 6: 3.0}),
             jtrainer.multiband_loss(jmodel, variables, {5: images, 6: 2 * images},
                                     {5: labels, 6: labels}, {5: 1.0, 6: 3.0})),
        ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# -- the schedule, devices ------------------------------------------------------------


@pytest.mark.parametrize("lr,horizon,alpha", [(1e-3, 7, 0.01), (7e-4, 1, 0.01),
                                              (2e-3, 25, 0.0)])
def test_cosine_schedule_matches_optax(lr, horizon, alpha):
    """Every update count from 0 to horizon + 2 (past the horizon the rate
    stays at lr * alpha)."""
    mine = trainer.cosine_decay_schedule(lr, horizon, alpha)
    ref = optax.cosine_decay_schedule(lr, horizon, alpha=alpha)
    for count in range(horizon + 3):
        np.testing.assert_allclose(mine(count), float(ref(jnp.int32(count))), rtol=1e-6)
    assert mine(horizon + 2) == pytest.approx(lr * alpha, rel=1e-6)
    with pytest.raises(ValueError):
        trainer.cosine_decay_schedule(lr, 0)


def test_trainer_follows_its_schedule():
    """Each update runs at the schedule's rate for its count (as optax's
    scale_by_schedule), here a rate that halves each update."""
    model = PortMini()
    tr = trainer.Trainer(model, learning_rate=lambda n: 1e-2 * 0.5 ** n, device="cpu")
    images = np.zeros((U, B, 8, 8, 3), np.float32)
    labels = np.zeros((U, 256), np.float32)
    rates = []
    for _ in range(3):
        tr.train_step(images, labels)
        rates.append(tr.optimizer.param_groups[0]["lr"])
    assert rates == [1e-2, 5e-3, 2.5e-3]


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from gnuradio_wifi_imagetransfer_tpu_torch.channel import irs, sv

    with pytest.raises(RuntimeError, match="CUDA"):
        somanet.SOMANet(16, 16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        somanet.SOMANetPE(16, 16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(PortMini())
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Environment().reset(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        irs.IRSChannel(2, 1, 16).gen_nonlos(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        sv.SVChannel(4, (0, 0, 0), (1, 1, 1), 2, 1).gen_awgn()
    with pytest.raises(ValueError, match="'data'"):
        trainer.Trainer(PortMini(), mesh=make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        trainer.Trainer(PortMini(), device="cpu").train_step(
            np.zeros((U, B, 8, 8, 3), np.float32), np.zeros((U, 256), np.float32), mode="x")


def test_trainer_takes_uint8_like_normalised_floats():
    """A uint8 batch normalised on the device is the float batch that
    normalize_image makes on the host."""
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import normalize_image

    pixels = np.random.default_rng(5).integers(0, 256, (U, B, 8, 8, 3), dtype=np.uint8)
    tr = trainer.Trainer(PortMini(), device="cpu")
    got = tr._images(pixels)
    want = torch.from_numpy(np.moveaxis(normalize_image(pixels), -1, -3))
    assert got.shape == (U, B, 3, 8, 8) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
