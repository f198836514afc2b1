"""Misc demo utilities mirroring the reference's scratch scripts
(SURVEY.md §2.1 "Misc scratch"; a copy of the JAX package's
runtime/misc_demos.py on the port's runtime/apps.py and utils/image.py):

  RandomImageDemo   = tmp_app.py — pushes random noise images to the
                      browser on a timer (SocketIO demo, port 5002);
                      rebuilt on the SSE hub from runtime/apps.py.
  TcpImageSender    = upload_image.py — sends a grayscale ("B/W") image
                      over raw TCP (port 52002) as length-prefixed pickled
                      pieces with ACK pacing.
  TcpImageReceiver  = the matching consumer (the reference's counterpart
                      is socket_client.py / img_receiver.py; img_receiver's
                      UDP variant is runtime/bridge.py UdpSink).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil


class RandomImageDemo:
    """Timed random-image pusher (tmp_app.py behavior, port 5002).

    Generates a random RGB frame every ``interval`` seconds and publishes
    it through a callback (the web app path wires this to the SSE hub the
    way tmp_app.py emits over SocketIO)."""

    def __init__(self, shape=(100, 100, 3), interval: float = 1.0,
                 on_frame=None, seed: int = 0):
        self.shape = shape
        self.interval = interval
        self.on_frame = on_frame or (lambda arr: None)
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.frames_sent = 0

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            frame = self._rng.integers(0, 256, self.shape, dtype=np.uint8)
            self.on_frame(frame)
            self.frames_sent += 1
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class RandomImageApp:
    """The tmp_app.py web demo itself: serves templates/index.html at '/'
    (the reference's landing page, templates/index.html) and pushes the
    RandomImageDemo frames to the browser over the SSE hub — SocketIO on
    port 5002 in the reference (tmp_app.py:1-49)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5002,
                 interval: float = 1.0, shape=(100, 100, 3), seed: int = 0):
        from gnuradio_wifi_imagetransfer_tpu_torch.runtime import apps as _apps

        self.hub = _apps._SseHub()
        self.last_image_b64 = ""

        def on_frame(arr):
            b64 = _apps._jpeg_b64(arr)
            self.last_image_b64 = b64
            self.hub.publish({"image": b64})

        self.demo = RandomImageDemo(shape=shape, interval=interval,
                                    on_frame=on_frame, seed=seed)

        app = self

        class Handler(_apps.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if _apps._serve_static(self, self.path):
                    return
                if self.path == "/":
                    body = _apps._template("index.html")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body.encode())))
                    self.end_headers()
                    self.wfile.write(body.encode())
                    return
                if self.path == "/events":
                    import json as _json
                    import queue as _queue

                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    q = app.hub.subscribe()
                    try:
                        if app.last_image_b64:
                            self.wfile.write(
                                f"data: {_json.dumps({'image': app.last_image_b64})}\n\n".encode())
                            self.wfile.flush()
                        while True:
                            try:
                                ev = q.get(timeout=1.0)
                            except _queue.Empty:
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                                continue
                            self.wfile.write(
                                f"data: {_json.dumps(ev)}\n\n".encode())
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    finally:
                        app.hub.unsubscribe(q)
                    return
                self.send_response(404)
                self.end_headers()

        from http.server import ThreadingHTTPServer

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        self.demo.start()
        return self

    def stop(self):
        self.demo.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class TcpImageSender:
    """Grayscale image → TCP pieces with ACK pacing (upload_image.py).

    The reference converts the upload to black-and-white ('L'), detaches it
    into (10,10) pieces, and streams them over TCP 52002 waiting for an
    ACK per piece; this is that protocol over utils/image.py."""

    def __init__(self, image: np.ndarray, host: str = "127.0.0.1",
                 port: int = 0):
        if image.ndim == 3:                      # RGB -> luminance (B/W)
            image = np.round(
                image @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)
        self.image = image[..., None]            # (H, W, 1)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._serve_once, daemon=True)
        self._thread.start()
        return self

    def _serve_once(self):
        conn, _ = self._srv.accept()
        with conn:
            pieces = imgutil.detach_image(self.image)
            conn.sendall(struct.pack("=LLL", len(pieces),
                                     self.image.shape[0],
                                     self.image.shape[1]))
            for piece in pieces:
                blob = pickle.dumps(piece)
                conn.sendall(struct.pack("=L", len(blob)) + blob)
                if conn.recv(3) != b"ACK":
                    break
        self._srv.close()

    def join(self, timeout: float = 10.0):
        if self._thread is not None:
            self._thread.join(timeout)


def tcp_receive_image(host: str, port: int, timeout: float = 10.0) -> np.ndarray:
    """Consume a TcpImageSender stream and rebuild the grayscale image."""
    with socket.create_connection((host, port), timeout=timeout) as conn:
        hdr = _recv_exact(conn, 12)
        n_pieces, h, w = struct.unpack("=LLL", hdr)
        canvas = np.zeros((h, w, 1), dtype=np.uint8)
        for _ in range(n_pieces):
            (ln,) = struct.unpack("=L", _recv_exact(conn, 4))
            piece = pickle.loads(_recv_exact(conn, ln))
            imgutil.redraw_image(piece, canvas)
            conn.sendall(b"ACK")
    return canvas[..., 0]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed early")
        buf += chunk
    return buf
