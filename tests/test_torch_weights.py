"""The port's codec weights and JSCE facade against the JAX package's (CPU).

The trained checkpoint (the repo's 240 x 240, c = 128 npz, 174 arrays) is
carried into both facades and run at 48 x 48: the network is fully
convolutional, so every tensor is exercised at a small size. The random
initialisations of the two packages cannot agree (jax.random against a
torch.Generator), so a random-init case builds the JAX facade first and
carries its variables into the port. Tolerances: the latent within 1e-5
absolute (measured 7e-7: float32 convolutions summed in another order),
the decoder's float output within 1e-4, uint8 reconstructions within 1 LSB.
"""

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import jsce as jjsce
from gnuradio_wifi_imagetransfer_tpu.models import weights as jwt
from gnuradio_wifi_imagetransfer_tpu_torch.models import jsce
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.models.decoder import DecoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.encoder import Encoder

torch.set_num_threads(2)

USERS = ("3-4", "13-10")


def _images(hw, seed):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8) for u in USERS}


def _lsb(a, b):
    return int(np.abs(np.asarray(a, int) - np.asarray(b, int)).max())


# -- twins of tests/test_weights.py ------------------------------------------


def test_packaged_checkpoint_exists_and_loads():
    path = wt.default_checkpoint()
    assert path is not None and path == jwt.default_checkpoint()
    variables, meta = wt.load_soma_npz(path)
    assert (meta["compressed_channel"], meta["img_size"]) == (128, 240)
    assert meta["users"] == ["3-4", "13-10"]
    for u in meta["users"]:
        assert meta["holdout_metrics"][u]["psnr"] > 19.5, meta
    enc, dec = wt.split_soma(variables)
    assert "params" in enc and "batch_stats" in enc and "params" in dec
    flat = wt._flatten(variables)
    assert len(flat) == 173                  # the 174 arrays less __meta__
    assert all(v.dtype == np.float32 for v in flat.values())
    jflat = jwt._flatten(jwt.load_soma_npz(path)[0])
    assert flat.keys() == jflat.keys()
    assert all(np.array_equal(flat[k], jflat[k]) for k in flat)


def test_roundtrip_flatten_unflatten():
    tree = {"a": {"b": np.arange(3.0, dtype=np.float32)}, "c": np.ones((2, 2), np.float32)}
    flat = wt._flatten(tree)
    assert flat.keys() == jwt._flatten(tree).keys()
    back = wt._unflatten(flat)
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["c"], tree["c"])


def test_flatten_handles_frozen_mapping():
    import flax.core

    tree = {"params": flax.core.freeze({"layer": {"w": np.ones((2, 2), np.float32)}})}
    flat = wt._flatten(tree)
    assert set(flat) == {"params/layer/w"}
    assert flat["params/layer/w"].dtype == np.float32


def test_missing_weights_override_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("GWT_JSCE_WEIGHTS", str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError, match="GWT_JSCE_WEIGHTS"):
        wt.default_checkpoint()
    with pytest.raises(FileNotFoundError, match="GWT_JSCE_WEIGHTS"):
        jsce.JSCE.packaged(device="cpu")


def test_weights_override_names_the_checkpoint(monkeypatch):
    """GWT_JSCE_WEIGHTS picks another npz (here the small 80 x 80, c = 64
    one), and packaged() takes its geometry from its metadata."""
    small = str(wt.ASSETS / "jsce_soma_dscn.npz")
    monkeypatch.setenv("GWT_JSCE_WEIGHTS", small)
    assert wt.default_checkpoint() == small
    codec = jsce.JSCE.packaged(device="cpu")
    assert (codec.img_size, codec.c) == ((80, 80), 64)


# -- the carrier -------------------------------------------------------------


def test_carrier_fills_every_tensor_from_the_npz():
    enc, dec = wt.split_soma(wt.load_soma_npz(wt.default_checkpoint())[0])
    for tree, module in ((enc, Encoder(128)), (dec, DecoderPE(128, 3))):
        sd = wt.state_dict_from_flax(tree, module)
        assert sd.keys() == module.state_dict().keys()
        n_leaves = len(wt._flatten(tree))
        assert n_leaves == sum(not k.endswith("num_batches_tracked") for k in sd)
    # the 174 arrays: 173 leaves and __meta__; the carried ones and
    # params/shared_phi (the physics branch, not on the facade's path)
    assert len(wt._flatten(enc)) + len(wt._flatten(dec)) + 1 + 1 == 174


def test_carrier_refuses_a_stray_or_missing_leaf():
    enc, _ = wt.split_soma(wt.load_soma_npz(wt.default_checkpoint())[0])
    stray = {**enc, "params": {**enc["params"], "extra": {"kernel": np.zeros((1, 1, 2, 2))}}}
    with pytest.raises(KeyError, match="extra"):
        wt.state_dict_from_flax(stray, Encoder(128))
    short = {"params": {k: v for k, v in enc["params"].items() if k != "attention2"},
             "batch_stats": enc["batch_stats"]}
    with pytest.raises(KeyError, match="attention2"):
        wt.state_dict_from_flax(short, Encoder(128))
    with pytest.raises(ValueError):               # c = 128 leaves into a c = 64 encoder
        wt.state_dict_from_flax(enc, Encoder(64))


# -- the facade ----------------------------------------------------------------


@pytest.fixture(scope="module")
def packaged_48():
    """Both facades around the repo's 240 npz, at 48 x 48 input."""
    path = wt.default_checkpoint()
    return (jjsce.JSCE(weight_path=path, img_size=(48, 48), compressed_channel=128),
            jsce.JSCE(weight_path=path, img_size=(48, 48), compressed_channel=128,
                      device="cpu"))


def test_trained_codec_matches_jax(packaged_48):
    jcodec, codec = packaged_48
    imgs = _images(48, 0)
    want = jcodec.img2msg(imgs)
    got = codec.img2msg(imgs)
    assert got.shape == want.shape == (6, 6, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    for u in USERS:
        assert _lsb(codec.msg2img(want, u), jcodec.msg2img(want, u)) <= 1


def test_trained_decoder_output_matches_jax(packaged_48):
    jcodec, codec = packaged_48
    x = np.random.default_rng(1).standard_normal((1, 6, 6, 128)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    want = np.asarray(jcodec._dec_apply(jcodec.dec_vars, x, jcodec._label("13-10")))
    with torch.no_grad():
        got = codec.decoder(torch.from_numpy(x).permute(0, 3, 1, 2), codec._label("13-10"))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4)


def test_labels_index_the_pe_table_like_jax(packaged_48):
    jcodec, codec = packaged_48
    for key in ("3-4", "13-10", "40-50", "0-0", "29-29"):   # 40-50 clamps to the edge
        np.testing.assert_array_equal(codec._label(key).numpy(), np.asarray(jcodec._label(key)))
    assert codec.get_csi("13-10") == jcodec.get_csi("13-10") == 13 + 10j


def test_random_init_codec_carried_from_jax():
    """A JAX random-init facade (80 x 80, c = 32) carried into the port:
    the latent and both users' reconstructions."""
    jcodec = jjsce.JSCE(img_size=(80, 80), compressed_channel=32, rng_seed=1)
    codec = jsce.JSCE(img_size=(80, 80), compressed_channel=32,
                      params=(jcodec.enc_vars, jcodec.dec_vars), device="cpu")
    imgs = _images(80, 2)
    want = jcodec.img2msg(imgs)
    got = codec.img2msg(imgs)
    assert got.shape == (10, 10, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    for u in USERS:
        assert _lsb(codec.msg2img(want, u), jcodec.msg2img(want, u)) <= 1


def test_port_random_init_is_seeded():
    imgs = _images(16, 3)
    a = jsce.JSCE(img_size=(16, 16), compressed_channel=8, rng_seed=4, device="cpu")
    b = jsce.JSCE(img_size=(16, 16), compressed_channel=8, rng_seed=4, device="cpu")
    c = jsce.JSCE(img_size=(16, 16), compressed_channel=8, rng_seed=5, device="cpu")
    assert np.array_equal(a.img2msg(imgs), b.img2msg(imgs))
    assert not np.array_equal(a.img2msg(imgs), c.img2msg(imgs))


def test_facade_checks_its_inputs():
    codec = jsce.JSCE(img_size=(16, 16), compressed_channel=8, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        codec.img2msg({"3-4": np.zeros((8, 8, 3), np.uint8)})
    with pytest.raises(NotImplementedError):
        jsce.JSCE(codec="SOMA-GDN", device="cpu")
    with pytest.raises(ValueError, match="npz"):
        jsce.JSCE(weight_path="weights.pth", device="cpu")
    with pytest.raises(ValueError, match="compressed_channel"):
        jsce.JSCE(weight_path=wt.default_checkpoint(), compressed_channel=64, device="cpu")
    from PIL import Image

    # a PIL image is resized to the facade's geometry, as in JAX
    img = Image.fromarray(np.zeros((20, 30, 3), np.uint8))
    assert codec.img2msg({"3-4": img}).shape == (2, 2, 8)
    assert codec.warm() is codec


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        jsce.JSCE(img_size=(16, 16), compressed_channel=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        jsce.JSCE.packaged()
