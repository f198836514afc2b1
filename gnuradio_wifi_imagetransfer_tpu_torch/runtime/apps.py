"""Web applications: image and feature-map senders and receivers (PyTorch
port of the JAX package's runtime/apps.py; the same pages, routes and
wire).

Stdlib rebuilds of the reference's four Flask/Flask-SocketIO apps
(http.server and Server-Sent Events in place of SocketIO pushes):

  SenderApp             = upload_image_udp.py         (Mode 2 TX, port 5000)
  ReceiverApp           = download_image_udp.py       (Mode 2 RX, port 5001)
  FeatureMapSenderApp   = upload_featuremap_udp.py    (Mode 1 TX)
  FeatureMapReceiverApp = download_featuremap_udp.py  (Mode 1 RX)

Behavior:
  * senders resize to 300x300 (Mode 2) or fuse two 240x240 images through
    the JSCE codec (Mode 1), detach into shuffled pieces, and re-send the
    piece list until stopped, ``AppConfig.piece_interval_s`` apart
    (upload_image_udp.py:19-34);
  * receivers bind UDP 10010, draw pieces into a persistent canvas (uint8
    image or (30, 30, 128) float32 latent) and push base64 JPEG updates to
    the browser (download_image_udp.py:25-61,
    download_featuremap_udp.py:30-69); the Mode-1 receiver decodes every
    3rd piece with its codec, in its receive thread, for the user chosen in
    the UI (featuremap_receiver.html:16);
  * a receiver with a radio attached serves its probes and retunes it (the
    RF panel).

The Mode-1 apps use the codec they are given, on its own device (a
``models.jsce.JSCE``, "cuda" by default); warm it (``JSCE.warm()``) before
the receiver starts, so its first decode does not stall the receive
thread. The receive loop survives a bad datagram or a failed decode, as
the reference's does, and prints "dropped piece" with the traceback for
each, as the radios do.
"""

from __future__ import annotations

import base64
import functools
import io
import json
import pathlib
import pickle
import queue
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.config import AppConfig
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import RCVBUF_BYTES, _dropped
from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil

_PKG_DIR = pathlib.Path(__file__).parent
_STATIC_TYPES = {".css": "text/css", ".js": "text/javascript",
                 ".html": "text/html"}


@functools.cache
def _template(name: str) -> str:
    """Load a page template from runtime/templates/ — real files like the
    reference's templates/ dir (sender.html / receiver.html …)."""
    return (_PKG_DIR / "templates" / name).read_text()


def _serve_static(handler, path: str) -> bool:
    """GET /static/<file> from runtime/static/ (reference's static/ dir)."""
    if not path.startswith("/static/"):
        return False
    target = (_PKG_DIR / "static" / path[len("/static/"):]).resolve()
    if target.parent != (_PKG_DIR / "static").resolve() or not target.is_file():
        handler.send_response(404)
        handler.end_headers()
        return True
    body = target.read_bytes()
    handler.send_response(200)
    handler.send_header(
        "Content-Type", _STATIC_TYPES.get(target.suffix, "application/octet-stream"))
    # explicit length: correct under keep-alive too, not just the HTTP/1.0
    # connection-close framing BaseHTTPRequestHandler defaults to
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
    return True


def _jpeg_b64(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


class _AppServer:
    """Threaded HTTP server wrapper with clean start/stop."""

    def __init__(self, handler_cls, host: str = "127.0.0.1", port: int = 0):
        self.httpd = ThreadingHTTPServer((host, port), handler_cls)
        self.httpd.app = self            # handlers reach the app via server.app
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        # shutdown() blocks on an event that only serve_forever() sets;
        # calling it on a never-started server (an app driven through its
        # API without the HTTP front end, e.g. the Mode-2 soak) would
        # deadlock forever. server_close() alone releases the socket.
        if self._thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# Senders
# ---------------------------------------------------------------------------


class _PieceSender:
    """The infinite shuffled re-send loop (upload_image_udp.py:19-34)."""

    def __init__(self, pieces, host: str, port: int, interval: float):
        self.pieces = pieces
        self.addr = (host, port)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.laps = 0

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            while not self._stop.is_set():
                for piece in self.pieces:
                    if self._stop.is_set():
                        return
                    s.sendto(imgutil.encode_piece(piece), self.addr)
                    time.sleep(self.interval)
                self.laps += 1

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


class SenderApp(_AppServer):
    """Mode-2 image sender (upload_image_udp.py)."""

    def __init__(self, cfg: AppConfig = AppConfig(), http_port: int = 0):
        self.cfg = cfg
        self.sender: _PieceSender | None = None
        super().__init__(_make_sender_handler(self), port=http_port)

    def send_image(self, image: np.ndarray, port: int | None = None):
        """Start (or restart) the re-send loop for one image. ``port``
        overrides the target UDP port (the reference sender's port input,
        featuremap_sender.html:104-105)."""
        from PIL import Image

        if not isinstance(image, np.ndarray):
            image = np.asarray(image)
        img = np.asarray(
            Image.fromarray(image).resize(self.cfg.image_size), dtype=np.uint8)
        pieces = imgutil.detach_image(img, self.cfg.piece_size)
        self.stop_sending()
        self.sender = _PieceSender(pieces, self.cfg.tx_host,
                                   port or self.cfg.tx_port,
                                   self.cfg.piece_interval_s).start()

    def stop_sending(self):
        if self.sender is not None:
            self.sender.stop()
            self.sender = None

    def stop(self):
        self.stop_sending()
        super().stop()


class FeatureMapSenderApp(_AppServer):
    """Mode-1 fused-feature-map sender (upload_featuremap_udp.py): encodes
    TWO images for the hard-coded users TARGET=['3-4','13-10'] (:22) into
    one mean-superposed latent and streams its pieces."""

    TARGET = ["3-4", "13-10"]

    def __init__(self, codec, cfg: AppConfig = AppConfig(), http_port: int = 0):
        self.cfg = cfg
        self.codec = codec
        self.sender: _PieceSender | None = None
        super().__init__(_make_sender_handler(self, n_images=2), port=http_port)

    def send_image(self, img1, img2, port: int | None = None):
        latent = self.codec.img2msg({self.TARGET[0]: img1, self.TARGET[1]: img2})
        pieces = imgutil.detach_image(latent, self.cfg.piece_size)
        self.stop_sending()
        self.sender = _PieceSender(pieces, self.cfg.tx_host,
                                   port or self.cfg.tx_port,
                                   self.cfg.piece_interval_s).start()

    def stop_sending(self):
        if self.sender is not None:
            self.sender.stop()
            self.sender = None

    def stop(self):
        self.stop_sending()
        super().stop()


def _make_sender_handler(app, n_images: int = 1):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if _serve_static(self, self.path):
                return
            if isinstance(app, FeatureMapSenderApp):
                # dedicated Mode-1 page with the reference's port input
                # (featuremap_sender.html:104-105)
                body = _template("featuremap_sender.html").format(
                    title=type(app).__name__,
                    user_a=app.TARGET[0], user_b=app.TARGET[1],
                    port=app.cfg.tx_port,
                    status="sending" if app.sender else "idle")
            else:
                inputs = "".join(
                    f'<input type="file" name="image{i}"/><br/>'
                    for i in range(n_images))
                body = _template("sender.html").format(
                    title=type(app).__name__, inputs=inputs,
                    port=app.cfg.tx_port,
                    status="sending" if app.sender else "idle")
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body.encode())

        def do_POST(self):
            if self.path == "/stop":
                app.stop_sending()
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"stopped")
                return
            if self.path == "/send_image":
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                try:
                    imgs, fields = _parse_multipart(self.headers, data, n_images)
                    port = int(fields["port"]) if fields.get("port") else None
                    app.send_image(*imgs, port=port)
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"sending")
                except Exception as e:
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                return
            self.send_response(404)
            self.end_headers()

    return Handler


def _parse_multipart(headers, data: bytes, n_images: int):
    """Minimal multipart/form-data parser: file fields -> images, text
    fields -> a dict (e.g. the sender's target-port input)."""
    from PIL import Image

    ctype = headers.get("Content-Type", "")
    if "boundary=" not in ctype:
        raise ValueError("expected multipart/form-data")
    boundary = ctype.split("boundary=")[1].strip().encode()
    parts = data.split(b"--" + boundary)
    images, fields = [], {}
    for part in parts:
        if b"\r\n\r\n" not in part:
            continue
        head, payload = part.split(b"\r\n\r\n", 1)
        payload = payload.rstrip(b"\r\n-")
        if b"filename=" in head:
            if payload:
                images.append(Image.open(io.BytesIO(payload)).convert("RGB"))
        elif b'name="' in head:
            name = head.split(b'name="', 1)[1].split(b'"', 1)[0].decode()
            fields[name] = payload.decode(errors="replace").strip()
    if len(images) < n_images:
        raise ValueError(f"need {n_images} image file(s), got {len(images)}")
    return [np.asarray(im) for im in images[:n_images]], fields


# ---------------------------------------------------------------------------
# Receivers
# ---------------------------------------------------------------------------


class _SseHub:
    """Fan-out of JSON events to connected SSE clients."""

    def __init__(self):
        self._clients: list[queue.Queue] = []
        self._lock = threading.Lock()

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=4)
        with self._lock:
            self._clients.append(q)
        return q

    def unsubscribe(self, q):
        with self._lock:
            if q in self._clients:
                self._clients.remove(q)

    def publish(self, event: dict):
        with self._lock:
            clients = list(self._clients)
        for q in clients:
            try:
                q.put_nowait(event)
            except queue.Full:
                pass


class _ReceiverBase(_AppServer):
    def __init__(self, cfg: AppConfig, http_port: int, rx_port: int | None,
                 radio=None):
        # optional attached radio (LoopbackRadio / RxRadio): its
        # constellation/spectrum/snr probes are served at /constellation
        # and /spectrum (the browser stand-ins for the reference's Qt
        # const/freq sinks, IRS_AP.py:178-266), and its live setters at
        # POST /radio (the GUI-variable sliders, IRS_tranceiver.py:370-434)
        self.radio = radio
        self.cfg = cfg
        self.hub = _SseHub()
        self.last_image_b64: str | None = None
        self.pieces_received = 0
        self._stop_evt = threading.Event()
        self.rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # a radio that replays CUDA graphs delivers bursts faster than this
        # thread draws and decodes: the radios' deep kernel buffer (capped
        # by net.core.rmem_max) keeps more of them
        self.rx_sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
        self.rx_sock.bind((cfg.rx_host, cfg.rx_port if rx_port is None else rx_port))
        self.rx_sock.settimeout(1.0)            # download_image_udp.py:32
        self.rx_port = self.rx_sock.getsockname()[1]
        self._rx_thread = threading.Thread(target=self._rx_loop, daemon=True)
        super().__init__(_make_receiver_handler(self), port=http_port)

    def start(self):
        super().start()
        self._rx_thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._rx_thread.is_alive():          # join() before start() raises
            self._rx_thread.join(timeout=2.0)
        self.rx_sock.close()
        super().stop()

    def _rx_loop(self):
        while not self._stop_evt.is_set():
            try:
                data, _ = self.rx_sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                # radio path delivers bare pickles (prefix stripped by the
                # Extract-Pics contract); a direct app-to-app wire still
                # carries the 4-byte "=L" length prefix — accept both
                try:
                    piece = pickle.loads(data)
                except Exception:
                    piece = imgutil.decode_piece(data)
                self._handle_piece(piece)
            except Exception as e:            # keep receiving, as the reference does
                _dropped(type(self).__name__, "piece", e)

    def _publish(self, arr: np.ndarray):
        b64 = _jpeg_b64(arr)
        self.last_image_b64 = b64
        self.hub.publish({"image": b64, "pieces": self.pieces_received})

    def _handle_piece(self, piece):
        raise NotImplementedError


class ReceiverApp(_ReceiverBase):
    """Mode-2 image receiver (download_image_udp.py): persistent 300x300x3
    canvas, redraw each piece, push update."""

    def __init__(self, cfg: AppConfig = AppConfig(), http_port: int = 0,
                 rx_port: int | None = None, radio=None):
        super().__init__(cfg, http_port, rx_port, radio=radio)
        h, w = cfg.image_size
        self.canvas = np.zeros((h, w, 3), dtype=np.uint8)

    def _handle_piece(self, piece):
        imgutil.redraw_image(piece, self.canvas, self.cfg.piece_size)
        self.pieces_received += 1
        self._publish(self.canvas)


class FeatureMapReceiverApp(_ReceiverBase):
    """Mode-1 receiver (download_featuremap_udp.py): (30,30,128) float32
    accumulator; every 3rd piece runs codec.msg2img for the selected user
    (:59-69) and pushes the reconstruction."""

    def __init__(self, codec, user_id: str = "3-4", latent_shape=(30, 30, 128),
                 decode_every: int = 3, cfg: AppConfig = AppConfig(),
                 http_port: int = 0, rx_port: int | None = None, radio=None):
        super().__init__(cfg, http_port, rx_port, radio=radio)
        self.codec = codec
        self.user_id = user_id
        self.feature_map = np.zeros(latent_shape, dtype=np.float32)
        self.decode_every = decode_every

    def _handle_piece(self, piece):
        imgutil.redraw_image(piece, self.feature_map, self.cfg.piece_size)
        self.pieces_received += 1
        if self.pieces_received % self.decode_every == 0:
            rec = np.asarray(self.codec.msg2img(self.feature_map, self.user_id))
            self._publish(rec)


def _make_receiver_handler(app):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if _serve_static(self, self.path):
                return
            if self.path == "/":
                if isinstance(app, FeatureMapReceiverApp):
                    # dedicated Mode-1 page with the reference's user-id
                    # input (featuremap_receiver.html:16)
                    body = _template("featuremap_receiver.html").format(
                        title=type(app).__name__, user_id=app.user_id)
                else:
                    controls = (_template("rf_panel.html")
                                if app.radio is not None else "")
                    body = _template("receiver.html").format(
                        title=type(app).__name__, controls=controls)
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body.encode())
                return
            if self.path == "/events":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q = app.hub.subscribe()
                try:
                    if app.last_image_b64:
                        self.wfile.write(
                            f"data: {json.dumps({'image': app.last_image_b64})}\n\n".encode())
                        self.wfile.flush()
                    while True:
                        try:
                            ev = q.get(timeout=1.0)
                        except queue.Empty:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    app.hub.unsubscribe(q)
                return
            if self.path == "/status":
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(
                    {"pieces_received": app.pieces_received}).encode())
                return
            if self.path == "/constellation" and app.radio is not None:
                # equalized-symbol scatter + running SNR — the Qt
                # const_sink_c analogue (IRS_AP.py:178-200,312-313)
                pts = app.radio.constellation.points(512)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({
                    "points": np.round(pts, 4).tolist(),
                    "snr_db": round(app.radio.snr_probe.snr_db(), 2)
                    if app.radio.snr_probe.m2 is not None else None,
                }).encode())
                return
            if self.path == "/spectrum" and app.radio is not None:
                # averaged PSD — the qtgui.freq_sink_c analogue
                # (IRS_AP.py:226-266)
                psd = app.radio.spectrum.psd_db()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({
                    "psd_db": np.round(psd, 2).tolist(),
                    "nfft": int(psd.size),
                }).encode())
                return
            self.send_response(404)
            self.end_headers()

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            # exact route match on the PARSED path: a prefix test would
            # also accept /set_userX or /radioactive?mcs=7 and mutate state
            route = urlparse(self.path).path
            if route == "/set_user" and isinstance(app, FeatureMapReceiverApp):
                qs = parse_qs(urlparse(self.path).query)
                app.user_id = qs.get("id", [app.user_id])[0]
                self.send_response(200)
                self.end_headers()
                return
            if route == "/radio" and app.radio is not None:
                # live radio reconfiguration — the browser stand-in for
                # the reference's GUI variable sliders/choosers
                # (IRS_tranceiver.py:370-375,429-434; IRS_user.py:221-273)
                qs = parse_qs(urlparse(self.path).query)
                applied = {}
                try:
                    if "mcs" in qs and hasattr(app.radio, "set_encoding"):
                        app.radio.set_encoding(int(qs["mcs"][0]))
                        applied["mcs"] = app.radio.mcs
                    if "snr" in qs and hasattr(app.radio, "set_snr"):
                        app.radio.set_snr(float(qs["snr"][0]))
                        applied["snr"] = app.radio.snr_db
                    if "epsilon" in qs and hasattr(app.radio, "set_epsilon"):
                        app.radio.set_epsilon(float(qs["epsilon"][0]))
                        applied["epsilon"] = app.radio.epsilon
                    if "chan_est" in qs and hasattr(app.radio, "set_chan_est"):
                        app.radio.set_chan_est(int(qs["chan_est"][0]))
                        applied["chan_est"] = int(app.radio.chan_est)
                except (KeyError, ValueError) as e:
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(applied).encode())
                return
            self.send_response(404)
            self.end_headers()

    return Handler
