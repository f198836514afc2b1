"""Mode 1 on the port (CPU): the JSCE latent over the port's PHY and the
feature-map apps, against the JAX package.

Twins of tests/test_mode1_e2e.py and tests/test_mode1_apps.py at their
size (80 x 80 images, a (10, 10, 32) latent, 32 pieces). Both packages'
random inits cannot agree, so the codec is the JAX package's random-init
facade carried into the port; its latent lies within 1e-5 of JAX's and
its reconstructions within 1 LSB. The float latent must cross the PHY and
the apps bit for bit.
"""

import io
import json
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.models.jsce import JSCE as JaxJSCE
from gnuradio_wifi_imagetransfer_tpu.runtime import apps as japps
from gnuradio_wifi_imagetransfer_tpu_torch.config import AppConfig
from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.apps import (
    FeatureMapReceiverApp,
    FeatureMapSenderApp,
)
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio
from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil

torch.set_num_threads(2)

IMG_HW = 80              # latent (10, 10, 32) -> 32 pieces of (10, 10, 1)
LATENT = (10, 10, 32)
USERS = ["3-4", "13-10"]


@pytest.fixture(scope="module")
def codecs():
    jcodec = JaxJSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=32)
    return jcodec, JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=32,
                        params=(jcodec.enc_vars, jcodec.dec_vars), device="cpu")


@pytest.fixture()
def images():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (IMG_HW, IMG_HW, 3), dtype=np.uint8),
            rng.integers(0, 256, (IMG_HW, IMG_HW, 3), dtype=np.uint8))


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(predicate, timeout, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _lsb(a, b):
    return int(np.abs(np.asarray(a, int) - np.asarray(b, int)).max())


def test_mode1_jsce_over_phy(codecs, images):
    """img2msg (two users fused) -> float32 latent pieces -> MAC -> the
    port's TX -> AWGN -> the port's sync and decode -> the latent bit for
    bit -> msg2img per user, equal to a decode without the PHY."""
    jcodec, codec = codecs
    img_a, img_b = images
    latent = codec.img2msg({USERS[0]: img_a, USERS[1]: img_b})
    assert latent.shape == LATENT and latent.dtype == np.float32
    np.testing.assert_allclose(latent, jcodec.img2msg({USERS[0]: img_a, USERS[1]: img_b}),
                               atol=1e-5)

    rng = np.random.default_rng(0)
    pieces = imgutil.detach_image(latent, rng=rng)
    mac_tx = mac.Mac()
    datagrams = [imgutil.encode_piece(p) for p in pieces]
    assert len({len(d) for d in datagrams}) == 1
    mpdus = np.stack([np.frombuffer(mac_tx.frame(d), np.uint8) for d in datagrams])
    mcs = 5                              # 16-QAM 3/4
    bursts = tx.transmit(mpdus, mcs, scrambler_seed=torch.arange(len(mpdus)) % 127 + 1,
                         device="cpu")
    stream = tx.pad_burst(bursts, 120, 280).reshape(-1).numpy()
    noise = 0.5 * 10 ** (-28 / 20) / np.sqrt(2)
    stream = stream + noise * (rng.standard_normal(stream.size)
                               + 1j * rng.standard_normal(stream.size))
    res, cand = sync.receive(stream.astype(np.complex64), tx.tx_plan(mcs, mpdus.shape[1]),
                             max_frames=2 * len(pieces), device="cpu")
    ok = (cand.valid & res.sig["parity_ok"]).numpy()
    rebuilt = np.zeros_like(latent)
    n_drawn = 0
    for row in res.psdu.numpy()[ok]:
        f = mac.parse(row.tobytes())
        if f.fcs_ok:
            imgutil.redraw_image(imgutil.decode_piece(f.payload), rebuilt)
            n_drawn += 1
    assert n_drawn >= len(pieces)
    np.testing.assert_array_equal(rebuilt, latent)

    recs = {}
    for u in USERS:
        recs[u] = np.asarray(codec.msg2img(rebuilt, u))
        assert recs[u].shape == (IMG_HW, IMG_HW, 3)
        np.testing.assert_array_equal(recs[u], np.asarray(codec.msg2img(latent, u)))
        assert _lsb(recs[u], jcodec.msg2img(latent, u)) <= 1
    assert not np.array_equal(recs[USERS[0]], recs[USERS[1]])


def test_mode1_apps_direct_wire_and_set_user(codecs, images):
    """The sender fuses two images; the receiver draws the latent, decodes
    every 3rd piece, and /set_user switches the user; the pages are the
    JAX apps'."""
    _, codec = codecs
    img_a, img_b = images
    rx_port = _free_port()
    cfg = AppConfig(tx_port=rx_port, piece_interval_s=0.002)
    receiver = FeatureMapReceiverApp(codec, user_id="3-4", latent_shape=LATENT, cfg=cfg,
                                     rx_port=rx_port).start()
    sender = FeatureMapSenderApp(codec, cfg=cfg)
    sender.start()
    jreceiver = japps.FeatureMapReceiverApp(None, user_id="3-4", rx_port=0).start()
    try:
        sender.send_image(img_a, img_b)
        latent = codec.img2msg({"3-4": img_a, "13-10": img_b})
        n_pieces = (LATENT[0] // 10) * (LATENT[1] // 10) * LATENT[2]
        assert _wait(lambda: sender.sender is not None and sender.sender.laps >= 1, 30)
        assert _wait(lambda: receiver.pieces_received >= n_pieces, 20)
        np.testing.assert_array_equal(receiver.feature_map, latent)
        assert receiver.last_image_b64 is not None
        rec_direct = np.asarray(codec.msg2img(latent, "3-4"))
        np.testing.assert_array_equal(
            np.asarray(codec.msg2img(receiver.feature_map, receiver.user_id)), rec_direct)

        base = f"http://127.0.0.1:{receiver.port}"
        with urllib.request.urlopen(base + "/", timeout=5) as r:
            page = r.read()
        assert b'id="uid"' in page and b"feature-map receiver" in page
        with urllib.request.urlopen(f"http://127.0.0.1:{jreceiver.port}/", timeout=5) as r:
            assert page == r.read()
        req = urllib.request.Request(base + "/set_user?id=13-10", method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        assert receiver.user_id == "13-10"
        rec_b = np.asarray(codec.msg2img(receiver.feature_map, receiver.user_id))
        assert not np.array_equal(rec_b, rec_direct)
        with urllib.request.urlopen(base + "/status", timeout=5) as r:
            assert json.loads(r.read())["pieces_received"] >= n_pieces
        stop = urllib.request.Request(f"http://127.0.0.1:{sender.port}/stop", method="POST")
        with urllib.request.urlopen(stop, timeout=5) as r:
            assert r.read() == b"stopped"
        assert sender.sender is None
    finally:
        sender.stop()
        receiver.stop()
        jreceiver.stop()


def test_mode1_http_multipart_upload(codecs, images):
    """POST /send_image with two PNG files and a port field starts the
    fused-latent loop to that port; the page is the JAX app's."""
    from PIL import Image

    _, codec = codecs
    img_a, img_b = images
    rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx_sock.bind(("127.0.0.1", 0))
    cfg = AppConfig(tx_port=_free_port(), piece_interval_s=0.005)
    sender = FeatureMapSenderApp(codec, cfg=cfg)
    sender.start()
    jsender = japps.FeatureMapSenderApp(None, cfg=jconfig.AppConfig(tx_port=cfg.tx_port)).start()
    try:
        boundary = "testboundary42"
        body = io.BytesIO()
        for i, img in enumerate((img_a, img_b)):
            png = io.BytesIO()
            Image.fromarray(img).save(png, format="PNG")
            body.write(f"--{boundary}\r\n".encode())
            body.write(f'Content-Disposition: form-data; name="image{i}"; '
                       f'filename="im{i}.png"\r\nContent-Type: image/png\r\n\r\n'.encode())
            body.write(png.getvalue())
            body.write(b"\r\n")
        body.write(f'--{boundary}\r\nContent-Disposition: form-data; name="port"\r\n\r\n'
                   f'{rx_sock.getsockname()[1]}\r\n--{boundary}--\r\n'.encode())
        with urllib.request.urlopen(f"http://127.0.0.1:{jsender.port}/", timeout=5) as r:
            jpage = r.read()
        req = urllib.request.Request(
            f"http://127.0.0.1:{sender.port}/send_image", data=body.getvalue(),
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.read() == b"sending"
        assert sender.sender is not None
        with urllib.request.urlopen(f"http://127.0.0.1:{sender.port}/", timeout=5) as r:
            page = r.read()
        assert b'name="port"' in page and b"feature-map sender" in page
        assert b"3-4" in page and b"13-10" in page
        assert page == jpage.replace(b"idle", b"sending")
        rx_sock.settimeout(10.0)
        data, _ = rx_sock.recvfrom(65536)       # pieces flow to the posted port
        assert imgutil.decode_piece(data)[1].dtype == np.float32
        bad = urllib.request.Request(
            f"http://127.0.0.1:{sender.port}/send_image", data=b"x",
            headers={"Content-Type": "text/plain"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        sender.stop()
        jsender.stop()
        rx_sock.close()


def test_mode1_full_reference_topology(codecs, images):
    """Fused latent pieces -> the port's LoopbackRadio (802.11a PHY and
    channel, on the CPU) -> FeatureMapReceiverApp's reconstruction."""
    _, codec = codecs
    img_a, img_b = images
    out_port = _free_port()
    radio = LoopbackRadio(in_port=0, out_port=out_port, mcs=5, snr_db=26.0, batch=4,
                          device="cpu").start()
    cfg = AppConfig(tx_port=radio.in_port, piece_interval_s=0.01)
    receiver = FeatureMapReceiverApp(codec, user_id="13-10", latent_shape=LATENT, cfg=cfg,
                                     rx_port=out_port).start()
    sender = FeatureMapSenderApp(codec, cfg=cfg)
    sender.start()
    try:
        sender.send_image(img_a, img_b)
        latent = codec.img2msg({"3-4": img_a, "13-10": img_b})
        assert _wait(lambda: np.array_equal(receiver.feature_map, latent), 150, 0.5), (
            f"latent match {np.mean(receiver.feature_map == latent):.2%}, "
            f"radio stats {radio.stats}")
        np.testing.assert_array_equal(np.asarray(codec.msg2img(receiver.feature_map, "13-10")),
                                      np.asarray(codec.msg2img(latent, "13-10")))
    finally:
        sender.stop()
        radio.stop()
        receiver.stop()
