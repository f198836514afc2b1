"""The port's JSCE codec modules against the JAX package's (CPU).

Each case builds the Flax module, initialises it with a jax.random key,
redraws every leaf from a numpy seed (BatchNorm statistics, GDN's beta and
a non-symmetric gamma, PReLU slopes, kernels and biases: an initial value
such as an identity gamma or zero means would hide a swapped axis),
carries the variables into the port's module with
``weights.state_dict_from_flax``, and feeds both the same numpy input
(NHWC to JAX, NCHW to the port). Tolerances are those of the JAX package's
own codec tests (tests/test_codec.py), float32 on both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import afb as jafb
from gnuradio_wifi_imagetransfer_tpu.models import decoder as jdecoder
from gnuradio_wifi_imagetransfer_tpu.models import encoder as jencoder
from gnuradio_wifi_imagetransfer_tpu.models import jsce as jjsce
from gnuradio_wifi_imagetransfer_tpu.models import layers as jlayers
from gnuradio_wifi_imagetransfer_tpu.models import rcb as jrcb
from gnuradio_wifi_imagetransfer_tpu.utils import metrics as jmetrics
from gnuradio_wifi_imagetransfer_tpu_torch.models import afb, decoder, encoder, jsce, layers, rcb
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.utils import metrics

torch.set_num_threads(2)


def _redraw(variables, seed):
    """Every leaf of a Flax variables tree redrawn from a numpy seed, in a
    range the layer is sane in."""
    rng = np.random.default_rng(seed)
    flat = wt._flatten(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for path, v in flat.items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            new = rng.standard_normal(v.shape) / np.sqrt(fan_in)
        elif leaf in ("var", "scale", "beta"):
            new = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "gamma":
            new = np.sqrt(0.1 * np.eye(v.shape[0]) + rng.uniform(0.0, 0.05, v.shape))
        elif leaf == "alpha":
            new = rng.uniform(0.0, 0.5, v.shape)
        else:                                   # bias, mean
            new = 0.1 * rng.standard_normal(v.shape)
        out[path] = new.astype(np.float32)
    return wt._unflatten(out)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _twin(jmod, tmod, x, *extra, seed=0, atol, rtol=0.0, jax_kw=None):
    """(JAX output NHWC, port output NHWC) on the same input and weights."""
    jx = jnp.asarray(x)
    jextra = [jnp.asarray(e) for e in extra]
    variables = _redraw(jmod.init(jax.random.key(seed), jx, *jextra, **(jax_kw or {})), seed)
    want = np.asarray(jmod.apply(variables, jx, *jextra, **(jax_kw or {})))
    tmod.load_state_dict(wt.state_dict_from_flax(variables, tmod))
    tmod.eval()
    with torch.no_grad():
        got = tmod(_nchw(x), *[torch.from_numpy(e) for e in extra]).numpy()
    got = np.moveaxis(got, 1, -1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    return want, got


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax(inverse):
    _twin(jlayers.GDN(8, inverse=inverse), layers.GDN(8, inverse=inverse),
          _x((2, 5, 5, 8), 0), atol=2e-5)


def test_prelu_and_hard_swish_match_jax():
    x = _x((2, 4, 4, 6), 1)
    _twin(jlayers.PReLU(6), torch.nn.PReLU(6), x, atol=0.0)
    want = np.asarray(jlayers.hard_swish(jnp.asarray(x)))
    got = torch.nn.functional.hardswish(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_se_module_matches_jax():
    # BatchNorm on the 1 x 1 squeezed map, eval mode, eps 1e-5
    _twin(jlayers.SeModule(16), layers.SeModule(16), _x((2, 6, 6, 16), 2), atol=2e-5)


@pytest.mark.parametrize("in_size,out,stride,se", [(3, 128, 2, False), (128, 128, 2, False),
                                                   (64, 128, 1, False), (128, 128, 1, False),
                                                   (32, 48, 2, True)])
def test_rcb_matches_jax(in_size, out, stride, se):
    _twin(jrcb.RCB(3, in_size, 96, out, stride, se=se), rcb.RCB(3, in_size, 96, out, stride, se=se),
          _x((2, 16, 16, in_size), 3), atol=1e-4)


@pytest.mark.parametrize("in_ch,out_ch,stride", [(128, 256, 1), (256, 128, 2), (128, 3, 2),
                                                 (128, 256, 2)])
def test_rtcb_matches_jax(in_ch, out_ch, stride):
    """(128, 256, 2) is the non-square transposed conv at stride 2: a
    swapped in/out axis of the (kh, kw, O, I) kernel cannot pass it."""
    want, _ = _twin(jrcb.RTCB(in_ch, out_ch, stride), rcb.RTCB(in_ch, out_ch, stride),
                    _x((2, 8, 8, in_ch), 4), atol=5e-4, rtol=1e-4)
    assert want.shape == (2, 8 * stride, 8 * stride, out_ch)


def test_conv_transpose_is_torch_conv_transpose():
    """The JAX package's lax emulation and torch's ConvTranspose2d(3, 2,
    padding=1, output_padding=1) agree on a 5 x 7 map, 6 -> 10 channels."""
    _twin(jrcb.ConvTransposeTorch(10, 3, 2, pad=1), rcb.conv_transpose(6, 10, 3, 2, 1),
          _x((1, 5, 7, 6), 5), atol=1e-5)


def test_afb_pe_matches_jax():
    pe = _x((256,), 6)
    _twin(jafb.AFBPE(32), afb.AFBPE(32), _x((2, 6, 6, 32), 7), pe, atol=2e-5)


def test_encoder_matches_jax():
    pe = _x((256,), 8)
    want, _ = _twin(jencoder.Encoder(128), encoder.Encoder(128), _x((1, 48, 48, 3), 9), pe,
                    atol=5e-4)
    assert want.shape == (1, 6, 6, 128)


def test_decoder_pe_matches_jax():
    pe = _x((256,), 10)
    x = _x((1, 6, 6, 32), 11)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)           # msg2img's input
    want, _ = _twin(jdecoder.DecoderPE(32, 3), decoder.DecoderPE(32, 3), x, pe,
                    atol=1e-3, rtol=1e-3)
    assert want.shape == (1, 48, 48, 3)
    assert np.isfinite(want).all()


def test_positional_encoding_and_normalisation_match_jax():
    np.testing.assert_array_equal(jsce.positionalencoding2d(256, 60, 60),
                                  jjsce.positionalencoding2d(256, 60, 60))
    with pytest.raises(ValueError):
        jsce.positionalencoding2d(18, 4, 4)
    img = np.random.default_rng(12).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jsce.normalize_image(img), jjsce.normalize_image(img))
    n = jsce.normalize_image(img)
    np.testing.assert_array_equal(jsce.denormalize(n), jjsce.denormalize(n))
    np.testing.assert_array_equal(jsce.IMAGENET_MEAN, jjsce.IMAGENET_MEAN)
    np.testing.assert_array_equal(jsce.IMAGENET_STD, jjsce.IMAGENET_STD)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    noisy = np.clip(a.astype(int) + rng.integers(-10, 10, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) > 80
    assert metrics.psnr(a, noisy) == jmetrics.psnr(a, noisy)
    assert 25 < metrics.psnr(a, noisy) < 45
    assert metrics.ssim(a[0], noisy[0], channel_axis=2) == jmetrics.ssim(a[0], noisy[0],
                                                                          channel_axis=2)
    assert metrics.ssim(a[0], a[0], channel_axis=2) > 0.999
    np.testing.assert_array_equal(metrics._uniform_filter(a[0, ..., 0].astype(float), 7),
                                  jmetrics._uniform_filter(a[0, ..., 0].astype(float), 7))
    np.testing.assert_array_equal(metrics.rgb2ycbcr(a), jmetrics.rgb2ycbcr(a))
    white = np.full((1, 1, 3), 255, dtype=np.uint8)
    assert abs(int(metrics.rgb2ycbcr(white)[0, 0, 0]) - 235) <= 1
    with pytest.raises(ValueError):
        metrics.rgb2ycbcr(a.astype(np.float32))
    f = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(metrics.denormalize_batch(f), jmetrics.denormalize_batch(f))


@pytest.mark.parametrize("mcs", [None, 2, 4])
def test_snr_estimate_matches_jax(mcs):
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import params

    rng = np.random.default_rng(0)
    pts = params.constellation(int(params.MCS_N_BPSC[mcs if mcs is not None else 2]))
    syms = pts[rng.integers(0, pts.size, 4000)]
    noise = 0.05 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))
    est = metrics.snr_estimate_db(syms + noise, mcs=mcs)
    assert est == jmetrics.snr_estimate_db(syms + noise, mcs=mcs)
    if mcs is not None:
        assert abs(est - 10 * np.log10(np.mean(np.abs(pts) ** 2)
                                       / np.mean(np.abs(noise) ** 2))) < 1.5


def test_fp32_convs_holds_across_threads():
    """cuDNN's flags are the process's: while any thread is inside
    fp32_convs, TF32 stays off and algorithms deterministic, however the
    threads interleave; the last one out restores the flags."""
    import sys
    import threading
    import time

    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    bad = []

    def worker(i):
        for _ in range(50):
            with layers.fp32_convs():
                time.sleep(0.0001 * (i % 3))
                if cudnn.allow_tf32 or not cudnn.deterministic or cudnn.benchmark:
                    bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark) == before
