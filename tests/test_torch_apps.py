"""The port's Mode-2 web apps, socket and misc demos and image pieces
against the JAX package's (CPU).

Twins of tests/test_runtime.py (the socket demo, the apps over a direct
wire and over the port's LoopbackRadio, the RF panel, stop before start,
exact POST routes), tests/test_misc_demos.py and the image cases of
tests/test_mac_image.py. Pages and JSON are compared with the JAX apps'
byte for byte, images and decoded frames exactly.
"""

import json
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.phy import mac as jmac
from gnuradio_wifi_imagetransfer_tpu.phy import sync as jsync
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu.runtime import apps as japps
from gnuradio_wifi_imagetransfer_tpu.runtime import bridge as jbridge
from gnuradio_wifi_imagetransfer_tpu.runtime import misc_demos as jmisc
from gnuradio_wifi_imagetransfer_tpu.utils import image as jimage
from gnuradio_wifi_imagetransfer_tpu_torch.config import AppConfig
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import apps, misc_demos, socket_demo
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.apps import ReceiverApp, SenderApp
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio
from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil

torch.set_num_threads(2)


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url):
    req = urllib.request.Request(url, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _wait(predicate, timeout, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# -- tests/test_runtime.py ---------------------------------------------------


def test_socket_demo_roundtrip():
    img = np.random.default_rng(0).integers(0, 256, (30, 30, 3), dtype=np.uint8)
    server = socket_demo.PieceServer(img).start()
    got = socket_demo.receive_image("127.0.0.1", server.port)
    server.join()
    assert not server._thread.is_alive()
    assert np.array_equal(got, img)


def test_apps_direct_wire():
    """SenderApp -> UDP -> ReceiverApp: the canvas converges, the pages and
    static files are the JAX apps' byte for byte, SSE payloads flow."""
    rx_port = _free_port()
    cfg = AppConfig(tx_port=rx_port, image_size=(20, 20), piece_interval_s=0.002)
    receiver = ReceiverApp(cfg=cfg, rx_port=rx_port).start()
    sender = SenderApp(cfg=cfg)
    sender.start()
    jcfg = jconfig.AppConfig(tx_port=rx_port, image_size=(20, 20))
    jsender, jreceiver = japps.SenderApp(cfg=jcfg).start(), japps.ReceiverApp(
        cfg=jcfg, rx_port=0).start()
    try:
        img = np.random.default_rng(2).integers(0, 256, (20, 20, 3), dtype=np.uint8)
        sender.send_image(img)
        status = f"http://127.0.0.1:{receiver.port}/status"
        assert _wait(lambda: json.loads(_get(status))["pieces_received"] >= 12, 20)
        assert _wait(lambda: np.array_equal(receiver.canvas, img), 5)
        assert receiver.last_image_b64
        for app, japp in ((sender, jsender), (receiver, jreceiver)):
            for path in ("/static/receiver.js", "/static/style.css"):
                assert _get(f"http://127.0.0.1:{app.port}{path}") == _get(
                    f"http://127.0.0.1:{japp.port}{path}")
        assert b"/static/receiver.js" in _get(f"http://127.0.0.1:{receiver.port}/")
        assert _get(f"http://127.0.0.1:{receiver.port}/") == _get(
            f"http://127.0.0.1:{jreceiver.port}/")
        sender.stop_sending()
        jsender_page = _get(f"http://127.0.0.1:{jsender.port}/")
        assert b"send_image" in jsender_page
        assert _get(f"http://127.0.0.1:{sender.port}/") == jsender_page
        assert _post(f"http://127.0.0.1:{sender.port}/nothing")[0] == 404
    finally:
        for a in (sender, receiver, jsender, jreceiver):
            a.stop()


def test_static_files_stay_inside_the_static_dir():
    app = SenderApp(http_port=0).start()
    try:
        for path in ("/static/../apps.py", "/static/missing.css"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"http://127.0.0.1:{app.port}{path}")
            assert e.value.code == 404
    finally:
        app.stop()


def test_sse_stream_carries_the_canvas():
    rx_port = _free_port()
    cfg = AppConfig(tx_port=rx_port, image_size=(20, 20), piece_interval_s=0.002)
    receiver = ReceiverApp(cfg=cfg, rx_port=rx_port).start()
    sender = SenderApp(cfg=cfg)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{receiver.port}/events",
                                    timeout=10) as r:
            sender.send_image(np.full((20, 20, 3), 7, np.uint8))
            line = ""
            while not line.startswith("data: "):
                line = r.readline().decode()
            event = json.loads(line[6:])
        assert event["image"] and event["pieces"] >= 1
    finally:
        sender.stop()
        receiver.stop()


def test_full_reference_topology():
    """SenderApp -> UDP -> the port's LoopbackRadio (802.11a over the
    simulated channel, on the CPU) -> UDP -> ReceiverApp."""
    out_port = _free_port()
    radio = LoopbackRadio(in_port=0, out_port=out_port, mcs=2, snr_db=24.0, batch=4,
                          device="cpu").start()
    cfg = AppConfig(tx_port=radio.in_port, image_size=(20, 20), piece_interval_s=0.01)
    receiver = ReceiverApp(cfg=cfg, rx_port=out_port, radio=radio).start()
    sender = SenderApp(cfg=cfg)
    try:
        img = np.random.default_rng(3).integers(0, 256, (20, 20, 3), dtype=np.uint8)
        sender.send_image(img)
        assert _wait(lambda: np.array_equal(receiver.canvas, img), 120, 0.2), (
            f"canvas match {np.mean(receiver.canvas == img):.2%}, radio stats {radio.stats}")
    finally:
        sender.stop()
        radio.stop()
        receiver.stop()


def _seeded_probes(radio):
    radio.constellation.push(np.array([1 + 1j, -1 - 1j], np.complex64))
    radio.spectrum.update(np.exp(2j * np.pi * 0.1 * np.arange(2048)))
    radio.snr_probe.update(np.array([1.0 + 0.01j, -1.0 + 0.02j] * 64))


def test_receiver_app_rf_endpoints():
    """The RF panel: /constellation and /spectrum as the JAX app serves them
    for the same probe inputs, and POST /radio retunes the port's radio."""
    radio = LoopbackRadio(in_port=0, out_port=_free_port(), mcs=2, probes=True, device="cpu")
    jradio = jbridge.LoopbackRadio(in_port=0, out_port=_free_port(), mcs=2, probes=True)
    _seeded_probes(radio)
    _seeded_probes(jradio)
    app = ReceiverApp(http_port=0, rx_port=0, radio=radio).start()
    japp = japps.ReceiverApp(http_port=0, rx_port=0, radio=jradio).start()
    try:
        base, jbase = f"http://127.0.0.1:{app.port}", f"http://127.0.0.1:{japp.port}"
        page = _get(base + "/")
        assert b'id="const"' in page and page == _get(jbase + "/")
        c = json.loads(_get(base + "/constellation"))
        assert len(c["points"]) == 2 and c["snr_db"] is not None
        assert c == json.loads(_get(jbase + "/constellation"))
        s = json.loads(_get(base + "/spectrum"))
        assert s["nfft"] == len(s["psd_db"]) > 0 and max(s["psd_db"]) > -200.0
        np.testing.assert_allclose(s["psd_db"], json.loads(_get(jbase + "/spectrum"))["psd_db"],
                                   atol=0.011)            # both rounded to 0.01 dB
        status, body = _post(base + "/radio?mcs=4&snr=28&epsilon=1e-6&chan_est=1")
        assert status == 200
        assert json.loads(body) == {"mcs": 4, "snr": 28.0, "epsilon": 1e-6, "chan_est": 1}
        assert radio.mcs == 4 and radio.snr_db == 28.0 and radio.epsilon == 1e-6
        assert int(radio.chan_est) == 1
        assert _post(base + "/radio?mcs=x")[0] == 400
    finally:
        for a in (app, japp):
            a.stop()
        for r in (radio, jradio):
            r.source.stop()
            r.sink.close()


def test_app_stop_without_start_returns():
    send = SenderApp(http_port=0)
    recv = ReceiverApp(http_port=0, rx_port=0)
    done = threading.Event()

    def _stop_both():
        send.stop()
        recv.stop()
        done.set()

    threading.Thread(target=_stop_both, daemon=True).start()
    assert done.wait(timeout=10.0), "stop() deadlocked on a never-started app"


def test_post_routes_match_exact_path():
    radio = LoopbackRadio(in_port=0, out_port=_free_port(), mcs=2, device="cpu")
    app = ReceiverApp(http_port=0, rx_port=0, radio=radio).start()
    try:
        base = f"http://127.0.0.1:{app.port}"
        for path in ("/radioactive?mcs=7", "/radio/extra?mcs=7", "/set_user?id=1-1"):
            assert _post(base + path)[0] == 404, path
            assert radio.mcs == 2, f"{path} retuned the radio"
        assert _post(base + "/radio?mcs=7")[0] == 200 and radio.mcs == 7
    finally:
        app.stop()
        radio.source.stop()
        radio.sink.close()


def test_receive_loop_reports_a_bad_datagram(capsys):
    app = ReceiverApp(http_port=0, rx_port=0, cfg=AppConfig(image_size=(20, 20))).start()
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"not a piece", ("127.0.0.1", app.rx_port))
        good = ((0, 0, 0), np.full((10, 10, 1), 9, np.uint8))
        s.sendto(pickle.dumps(good), ("127.0.0.1", app.rx_port))
        s.close()
        assert _wait(lambda: app.pieces_received == 1, 10)
        assert (app.canvas[:10, :10, 0] == 9).all()
    finally:
        app.stop()
    assert "ReceiverApp: dropped piece" in capsys.readouterr().out


# -- tests/test_misc_demos.py --------------------------------------------------


def test_random_image_demo_pushes_frames():
    frames, jframes = [], []
    demo = misc_demos.RandomImageDemo(shape=(20, 20, 3), interval=0.01,
                                      on_frame=frames.append).start()
    jdemo = jmisc.RandomImageDemo(shape=(20, 20, 3), interval=0.01,
                                  on_frame=jframes.append).start()
    assert _wait(lambda: len(frames) >= 3 and len(jframes) >= 3, 5)
    demo.stop()
    jdemo.stop()
    assert frames[0].shape == (20, 20, 3)
    assert not np.array_equal(frames[0], frames[1])
    assert all(np.array_equal(a, b) for a, b in zip(frames[:3], jframes[:3]))


def test_tcp_bw_image_roundtrip():
    rgb = np.random.default_rng(0).integers(0, 256, (30, 30, 3), dtype=np.uint8)
    sender = misc_demos.TcpImageSender(rgb).start()
    got = misc_demos.tcp_receive_image("127.0.0.1", sender.port)
    sender.join()
    want = np.round(rgb @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    jsender = jmisc.TcpImageSender(rgb).start()
    np.testing.assert_array_equal(jmisc.tcp_receive_image("127.0.0.1", jsender.port), got)
    jsender.join()


def test_random_image_app_serves_index_and_sse():
    app = misc_demos.RandomImageApp(port=0, interval=0.05, shape=(16, 16, 3)).start()
    try:
        html = _get(f"http://127.0.0.1:{app.port}/").decode()
        assert "Random NumPy Array Image" in html and "EventSource" in html
        assert html == japps._template("index.html")
        with urllib.request.urlopen(f"http://127.0.0.1:{app.port}/events", timeout=5) as r:
            deadline = time.time() + 5
            payload = None
            while time.time() < deadline:
                line = r.readline().decode()
                if line.startswith("data: "):
                    payload = json.loads(line[6:])
                    break
        assert payload and payload["image"], "no SSE image event"
        assert _get(f"http://127.0.0.1:{app.port}/static/style.css") == (
            apps._PKG_DIR / "static" / "style.css").read_bytes()
    finally:
        app.stop()


# -- the image cases of tests/test_mac_image.py --------------------------------


def test_detach_rebuild_roundtrip_uint8():
    rng = np.random.default_rng(3)
    im = rng.integers(0, 256, (300, 300, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(im, rng=np.random.default_rng(3))
    jpieces = jimage.detach_image(im, rng=np.random.default_rng(3))
    assert len(pieces) == 30 * 30 * 3 and pieces[0][1].shape == (10, 10, 1)
    assert [p[0] for p in pieces] == [p[0] for p in jpieces]
    assert np.array_equal(imgutil.rebuild_image(pieces, im.shape), im)


def test_detach_rebuild_float_feature_map():
    fm = np.random.default_rng(4).standard_normal((30, 30, 128)).astype(np.float32)
    pieces = imgutil.detach_image(fm, rng=np.random.default_rng(4))
    assert len(pieces) == 3 * 3 * 128
    out = imgutil.rebuild_image(pieces, fm.shape)
    assert out.dtype == np.float32 and np.array_equal(out, fm)
    assert np.array_equal(out, jimage.rebuild_image(pieces, fm.shape))


def test_redraw_progressive():
    rng = np.random.default_rng(5)
    im = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(im, rng=rng)
    canvas, jcanvas = np.zeros_like(im), np.zeros_like(im)
    for p in pieces[: len(pieces) // 2]:
        imgutil.redraw_image(p, canvas)
        jimage.redraw_image(p, jcanvas)
    half_match = (canvas == im).mean()
    assert np.array_equal(canvas, jcanvas)
    for p in pieces[len(pieces) // 2 :]:
        imgutil.redraw_image(p, canvas)
    assert (canvas == im).all() and 0.2 < half_match < 0.9


def test_piece_wire_roundtrip():
    piece = ((10, 20, 1), np.arange(100, dtype=np.uint8).reshape(10, 10, 1))
    wire = imgutil.encode_piece(piece)
    assert wire == jimage.encode_piece(piece)
    pos, arr = imgutil.decode_piece(wire)
    assert pos == (10, 20, 1) and np.array_equal(arr, piece[1])
    assert imgutil.strip_transport(wire) == wire[4:]
    with pytest.raises(ValueError, match="truncated"):
        imgutil.decode_piece(wire[:-1])


def test_mode2_end_to_end_over_phy():
    """detach -> pickle + prefix -> MAC -> the port's TX -> a stream ->
    the port's sync and decode -> FCS -> redraw; the JAX receiver decodes
    the port's stream to the same frames."""
    rng = np.random.default_rng(6)
    im = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(im, rng=rng)           # 12 pieces
    datagrams = [imgutil.encode_piece(p) for p in pieces]
    assert len({len(d) for d in datagrams}) == 1
    mac_tx = mac.Mac()
    mpdus = np.stack([np.frombuffer(mac_tx.frame(d), dtype=np.uint8) for d in datagrams])
    jmac_tx = jmac.Mac()
    assert np.array_equal(mpdus, np.stack([np.frombuffer(jmac_tx.frame(d), dtype=np.uint8)
                                           for d in datagrams]))
    mcs, seeds = 2, np.arange(len(mpdus)) % 127 + 1
    bursts = tx.transmit(mpdus, mcs, scrambler_seed=torch.from_numpy(seeds), device="cpu")
    stream = tx.pad_burst(bursts, pad_front=120, pad_tail=280).reshape(-1)
    jstream = np.asarray(jtx.pad_burst(jtx.transmit(jnp.asarray(mpdus), mcs,
                                                    scrambler_seed=jnp.asarray(seeds)),
                                       pad_front=120, pad_tail=280).reshape(-1))
    np.testing.assert_allclose(stream.numpy(), jstream, atol=1e-5)
    plan = tx.tx_plan(mcs, mpdus.shape[1])
    res, cand = sync.receive(stream, plan, max_frames=16, device="cpu")
    ok = (cand.valid & res.sig["parity_ok"]).numpy()
    canvas = np.zeros_like(im)
    frames = []
    for row in res.psdu.numpy()[ok]:
        f = mac.parse(row.tobytes())
        if f.fcs_ok:
            imgutil.redraw_image(imgutil.decode_piece(f.payload), canvas)
            frames.append(row.tobytes())
    assert len(frames) == len(pieces) and np.array_equal(canvas, im)
    jres, jcand = jsync.receive(jnp.asarray(stream.numpy()), jtx.tx_plan(mcs, mpdus.shape[1]),
                                max_frames=16)
    jok = np.asarray(jcand.valid) & np.asarray(jres.sig["parity_ok"])
    assert [r.tobytes() for r in np.asarray(jres.psdu)[jok]] == frames
