"""The port's training codec blocks against the JAX package's (CPU).

GDN's lower-bound gradient rule, Flax's BatchNorm in train mode (output and
the updated batch_stats), every codec block that training adds (RCBGDN,
the depthwise transposed conv, RTCBDS, AFB, AFBcsi, EncoderCSI, EncoderPE,
Decoder, DecoderSA, DecoderDSCN, DecoderOriginal) and the reference's .pth
through both packages' loaders. As in tests/test_torch_codec.py, each case
initialises the Flax module, redraws every leaf from a numpy seed, carries
the variables into the port's module and feeds both the same numpy input.
Tolerances: those of tests/test_torch_codec.py for the same layer kinds
(float32 on both sides); batch statistics within 1e-5 (they move by 1 %
of a batch mean a step).
"""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import afb as jafb
from gnuradio_wifi_imagetransfer_tpu.models import decoder as jdecoder
from gnuradio_wifi_imagetransfer_tpu.models import encoder as jencoder
from gnuradio_wifi_imagetransfer_tpu.models import jsce as jjsce
from gnuradio_wifi_imagetransfer_tpu.models import layers as jlayers
from gnuradio_wifi_imagetransfer_tpu.models import rcb as jrcb
from gnuradio_wifi_imagetransfer_tpu_torch.models import afb, decoder, encoder, jsce, layers, rcb
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt

torch.set_num_threads(2)

_codec_tests = importlib.util.spec_from_file_location(
    "_torch_codec_twins", pathlib.Path(__file__).with_name("test_torch_codec.py"))
_twins = importlib.util.module_from_spec(_codec_tests)
_codec_tests.loader.exec_module(_twins)
_redraw, _nchw, _x = _twins._redraw, _twins._nchw, _twins._x


def _init(jmod, seed, *args):
    """The Flax module's variables (jitted: far cheaper on the CPU than
    Flax's eager init), every leaf redrawn from a numpy seed."""
    return _redraw(jax.jit(jmod.init)(jax.random.key(seed), *args), seed)


def _twin(jmod, tmod, x, *extra, seed=0, atol, rtol=0.0):
    """(JAX output NHWC, port output NHWC) on the same input and weights;
    extras go to both as they are (numpy -> tensor)."""
    jx = jnp.asarray(x)
    jextra = [jnp.asarray(e) for e in extra]
    variables = _init(jmod, seed, jx, *jextra)
    want = np.asarray(jax.jit(jmod.apply)(variables, jx, *jextra))
    tmod.load_state_dict(wt.state_dict_from_flax(variables, tmod))
    with torch.no_grad():
        got = tmod(_nchw(x), *[torch.from_numpy(np.asarray(e)) for e in extra]).numpy()
    got = np.moveaxis(got, 1, -1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    return want, got


# -- GDN's gradient rule -------------------------------------------------------


@pytest.mark.parametrize("g_sign", [1.0, -1.0])
def test_lower_bound_gradient_matches_jax_vjp(g_sign):
    """x below, at and above the bound, g of both signs: the port's
    backward equals jax.vjp of the JAX package's custom_vjp exactly."""
    bound = 2.0 ** -18
    x = np.array([bound - 1e-3, bound - 1e-9, bound, bound + 1e-9, 0.5, -1.0], np.float32)
    g = g_sign * np.array([1.0, 2.0, 0.5, 3.0, 1.5, 0.25], np.float32)
    g[1] = -g[1]                                  # mixed signs in one call
    y_j, vjp = jax.vjp(lambda v: jlayers.lower_bound(v, bound), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layers.lower_bound(xt, bound)
    y.backward(torch.from_numpy(g))
    assert np.array_equal(y.detach().numpy(), np.asarray(y_j))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))
    below = x < bound
    assert np.all(xt.grad.numpy()[below & (g >= 0)] == 0)
    assert np.all(xt.grad.numpy()[below & (g < 0)] == g[below & (g < 0)])


def _clamp_bound(x, bound):
    return torch.clamp(x, min=bound)


@pytest.mark.parametrize("rule", ["lower_bound", "clamp"])
def test_gdn_two_adam_steps_match_jax_and_clamp_does_not(rule, monkeypatch):
    """Two Adam steps (lr 1e-3) of a GDN at its initialisation, whose
    off-diagonal gammas sit exactly on their bound: the first step, on the
    loss mean(y * t), moves those with a positive gradient below it; the
    second, on its negation, gives them a negative gradient, which pushes
    them up. With LowerBound the port's gamma and beta equal JAX's within
    1e-7; with torch.clamp, which zeroes the gradient below the bound,
    gamma departs from JAX's by a sizeable part of lr."""
    if rule == "clamp":
        monkeypatch.setattr(layers, "lower_bound", _clamp_bound)
    ch, lr = 6, 1e-3
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, ch)).astype(np.float32)
    target = rng.standard_normal((2, 4, 4, ch)).astype(np.float32)
    jmod = jlayers.GDN(ch, inverse=True)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    tmod = layers.GDN(ch, inverse=True)
    tmod.load_state_dict(wt.state_dict_from_flax({"params": params}, tmod))
    tx = optax.adam(lr)
    opt = tx.init(params)
    topt = torch.optim.Adam(tmod.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for sign in (1.0, -1.0):
        t = sign * target

        def loss(p):
            return jnp.mean(jmod.apply({"params": p}, jnp.asarray(x)) * t)

        grads = jax.grad(loss)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        (tmod(_nchw(x)) * _nchw(t)).mean().backward()
        topt.step()
    gamma, want = tmod.gamma.detach().numpy(), np.asarray(params["gamma"])
    below = want < 2.0 ** -18
    assert below.any()                            # the case the rule decides
    err = np.abs(gamma - want).max()
    if rule == "lower_bound":
        assert err <= 1e-7, err
        np.testing.assert_allclose(tmod.beta.detach().numpy(), np.asarray(params["beta"]),
                                   atol=1e-7)
    else:
        assert err > 0.3 * lr, err


# -- BatchNorm in train mode ----------------------------------------------------


def _train_twin(jmod, tmod, x, seed, atol):
    """Train-mode forward of both on the same variables: the output and the
    updated batch_stats."""
    variables = _init(jmod, seed, jnp.asarray(x))
    want, mut = jax.jit(lambda v, x: jmod.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    tmod.load_state_dict(wt.state_dict_from_flax(variables, tmod))
    with torch.no_grad():
        got = np.moveaxis(tmod(_nchw(x), True).numpy(), 1, -1)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)
    stats = wt._flatten(wt.flax_from_module(tmod)["batch_stats"])
    jstats = wt._flatten(jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    assert stats.keys() == jstats.keys() and stats
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], atol=1e-5, err_msg=k)
    before = wt._flatten(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    assert any(not np.allclose(before[k], jstats[k]) for k in jstats)


def test_batchnorm_train_mode_matches_flax():
    """Flax's momentum 0.99 and biased variance, where nn.BatchNorm2d's
    defaults (0.1, unbiased) differ after one step."""
    import flax.linen as fnn

    class FlaxBN(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.BatchNorm(use_running_average=not train)(x)

    class PortBN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.BatchNorm_0 = layers.BatchNorm(8)

        def forward(self, x, train=False):
            return self.BatchNorm_0(x, train)

    x = _x((3, 5, 5, 8), 11) * 2.0 + 0.5
    _train_twin(FlaxBN(), PortBN(), x, 11, 1e-5)
    # eval mode normalises by the running averages, as before
    bn = layers.BatchNorm(8)
    bn.running_mean.fill_(0.5)
    bn.running_var.fill_(4.0)
    y = bn(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(y, (np.moveaxis(x, -1, 1) - 0.5) / np.sqrt(4.0 + 1e-5), atol=1e-6)


@pytest.mark.parametrize("in_size,out,stride,se", [(3, 128, 2, False), (128, 128, 2, False),
                                                   (64, 128, 1, False), (32, 48, 2, True)])
def test_rcb_train_mode_matches_jax(in_size, out, stride, se):
    _train_twin(jrcb.RCB(3, in_size, 96, out, stride, se=se),
                rcb.RCB(3, in_size, 96, out, stride, se=se), _x((2, 8, 8, in_size), 12), 12,
                atol=1e-4)


@pytest.mark.parametrize("in_size,expand,out,stride,se", [
    (128, 256, 256, 2, False), (64, 96, 3, 1, False), (32, 64, 32, 2, False),
    (32, 64, 32, 1, True)])
def test_rtcbds_train_mode_matches_jax(in_size, expand, out, stride, se):
    _train_twin(jrcb.RTCBDS(3, in_size, expand, out, stride, se=se),
                rcb.RTCBDS(3, in_size, expand, out, stride, se=se), _x((2, 6, 6, in_size), 13),
                13, atol=1e-4)


def test_se_module_train_mode_matches_jax():
    _train_twin(jlayers.SeModule(16), layers.SeModule(16), _x((4, 5, 5, 16), 14), 14, 2e-5)


# -- the blocks' forwards -------------------------------------------------------


@pytest.mark.parametrize("in_ch,out_ch,stride", [(3, 128, 2), (128, 128, 1), (64, 32, 1)])
def test_rcbgdn_matches_jax(in_ch, out_ch, stride):
    _twin(jrcb.RCBGDN(in_ch, out_ch, stride), rcb.RCBGDN(in_ch, out_ch, stride),
          _x((2, 8, 8, in_ch), 15), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_transpose_matches_jax(stride):
    want, _ = _twin(jrcb.DepthwiseConvTransposeTorch(3, stride, pad=1),
                    rcb.depthwise_conv_transpose(7, 3, stride, 1), _x((2, 5, 6, 7), 16),
                    atol=1e-5)
    assert want.shape == (2, 5 * stride, 6 * stride, 7)


@pytest.mark.parametrize("in_size,expand,out,stride", [(128, 256, 256, 2), (64, 96, 3, 1),
                                                       (32, 64, 32, 2)])
def test_rtcbds_eval_matches_jax(in_size, expand, out, stride):
    _twin(jrcb.RTCBDS(3, in_size, expand, out, stride),
          rcb.RTCBDS(3, in_size, expand, out, stride), _x((2, 6, 6, in_size), 17), atol=1e-4)


def test_afb_and_afbcsi_match_jax():
    x = _x((2, 4, 4, 32), 18)
    feature = jnp.asarray(x)
    snr = np.float32(20.0)
    mod = jafb.AFB(32)
    variables = _init(mod, 18, snr, feature)
    want = np.asarray(mod.apply(variables, snr, feature))
    port = afb.AFB(32)
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    with torch.no_grad():
        got = np.moveaxis(port(float(snr), _nchw(x)).numpy(), 1, -1)
    np.testing.assert_allclose(got, want, atol=2e-5)
    csi = np.array([0.7 - 1.2j], np.complex64)
    _twin(jafb.AFBcsi(1, 32), afb.AFBcsi(1, 32), x, csi, seed=19, atol=2e-5)


def test_encoder_train_and_variants_match_jax():
    pe = _x((256,), 20)
    # the live encoder in train mode (BatchNorm on batch statistics)
    x = _x((2, 16, 16, 3), 21)
    jmod = jencoder.Encoder(32)
    variables = _init(jmod, 21, jnp.asarray(x), jnp.asarray(pe))
    want, _ = jax.jit(lambda v, x, pe: jmod.apply(v, x, pe, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(pe))
    port = encoder.Encoder(32)
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(pe), True).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want), atol=5e-4)
    _twin(jencoder.EncoderPE(32), encoder.EncoderPE(32), x, pe, seed=22, atol=5e-4, rtol=1e-3)
    csi = np.array([1.5 + 0.5j], np.complex64)
    _twin(jencoder.EncoderCSI(1, 32), encoder.EncoderCSI(1, 32), x, csi, seed=23, atol=5e-4,
          rtol=1e-3)


def test_decoder_variants_match_jax():
    pe = _x((256,), 24)
    s = _x((1, 2, 2, 32), 25)
    _twin(jdecoder.DecoderSA(32), decoder.DecoderSA(32), s, seed=25, atol=1e-3, rtol=1e-3)
    csi = np.array([0.2 - 0.9j], np.complex64)
    _twin(jdecoder.Decoder(1, 32), decoder.Decoder(1, 32), s, csi, seed=26, atol=1e-3,
          rtol=1e-3)
    _twin(jdecoder.DecoderOriginal(20.0, 32), decoder.DecoderOriginal(20.0, 32), s, seed=27,
          atol=1e-3, rtol=1e-3)
    _twin(jdecoder.DecoderDSCN(32), decoder.DecoderDSCN(32), s, pe, seed=28, atol=1e-3,
          rtol=1e-3)
    # DecoderDSCN in train mode: output and batch_stats
    jmod = jdecoder.DecoderDSCN(32)
    variables = _init(jmod, 28, jnp.asarray(s), jnp.asarray(pe))
    want, mut = jax.jit(lambda v, s, pe: jmod.apply(v, s, pe, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(s), jnp.asarray(pe))
    port = decoder.DecoderDSCN(32)
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    with torch.no_grad():
        got = port(_nchw(s), torch.from_numpy(pe), True).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want), atol=1e-3, rtol=1e-3)
    stats = wt._flatten(wt.flax_from_module(port)["batch_stats"])
    jstats = wt._flatten(jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    assert stats.keys() == jstats.keys()
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], atol=1e-5, rtol=1e-5, err_msg=k)


# -- the reference's .pth -------------------------------------------------------


def test_pth_through_both_loaders_gives_the_same_codec(tmp_path):
    """A checkpoint in the reference's on-disk format (tests/test_codec.py's
    torch oracles: proc / shortcut / fn / skip Sequentials) through the JAX
    package's and the port's loaders and facades: the same variables leaf
    for leaf, the latent within 1e-5 and uint8 reconstructions within 1
    LSB."""
    spec = importlib.util.spec_from_file_location(
        "_jax_codec_oracles", pathlib.Path(__file__).with_name("test_codec.py"))
    oracles = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracles)
    torch.manual_seed(7)
    enc = oracles._rand_init(oracles.TorchEncoder(32), 11)
    dec = oracles.TorchDecoderPE(32, 3).eval()
    ckpt = {f"shared_encoder.{k}": v for k, v in enc.state_dict().items()}
    ckpt.update({f"shared_decoder.{k}": v for k, v in dec.state_dict().items()})
    path = str(tmp_path / "ckpt.pth")
    torch.save(ckpt, path)

    from gnuradio_wifi_imagetransfer_tpu.models import convert as jconvert
    from gnuradio_wifi_imagetransfer_tpu_torch.models import convert

    for got, want in zip(convert.load_torch_checkpoint(path),
                         jconvert.load_torch_checkpoint(path, 32)):
        g, w = wt._flatten(got), wt._flatten(want)
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[k], w[k]) for k in g)
    port = jsce.JSCE(weight_path=path, img_size=(32, 32), compressed_channel=32, device="cpu")
    ref = jjsce.JSCE(weight_path=path, img_size=(32, 32), compressed_channel=32)
    rng = np.random.default_rng(13)
    imgs = {u: rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for u in ("3-4", "13-10")}
    lat, jlat = port.img2msg(imgs), np.asarray(ref.img2msg(imgs))
    np.testing.assert_allclose(lat, jlat, atol=1e-5)
    rec = np.asarray(port.msg2img(jlat, "3-4"), int)
    assert np.abs(rec - np.asarray(ref.msg2img(jlat, "3-4"), int)).max() <= 1
