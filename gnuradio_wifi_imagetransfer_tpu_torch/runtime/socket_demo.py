"""No-radio TCP transport demo (socket_server.py / socket_client.py port;
a copy of the JAX package's runtime/socket_demo.py on the port's
utils/image.py).

Exercises detach -> transport -> rebuild over TCP with ACK flow control,
isolating the patchization layer from the PHY (SURVEY.md §4.2). The
reference displays with cv2.imshow; here the client exposes the rebuilt
canvas programmatically (and optionally via cv2 when a display exists).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil

ACK = b"ACK"


class PieceServer:
    """Sends an image's shuffled pieces over TCP, one per ACK
    (socket_server.py:17-31)."""

    def __init__(self, image: np.ndarray, host: str = "127.0.0.1", port: int = 0):
        self.image = image
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve_once, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _serve_once(self):
        conn, _ = self.sock.accept()
        with conn:
            # header: image shape
            conn.sendall(struct.pack("=3L", *self.image.shape))
            if conn.recv(16) != ACK:
                return
            pieces = imgutil.detach_image(self.image)
            conn.sendall(struct.pack("=L", len(pieces)))
            for piece in pieces:
                data = pickle.dumps(piece)
                conn.sendall(struct.pack("=L", len(data)) + data)
                if conn.recv(16) != ACK:
                    return
        self.sock.close()

    def join(self, timeout: float = 10.0):
        self._thread.join(timeout)


def receive_image(host: str, port: int, timeout: float = 10.0) -> np.ndarray:
    """Client: rebuild the image piece by piece (socket_client.py:13-37)."""
    with socket.create_connection((host, port), timeout=timeout) as conn:
        conn.settimeout(timeout)
        shape = struct.unpack("=3L", _recv_exact(conn, 12))
        conn.sendall(ACK)
        (n_pieces,) = struct.unpack("=L", _recv_exact(conn, 4))
        canvas = np.zeros(shape, dtype=np.uint8)
        for _ in range(n_pieces):
            (ln,) = struct.unpack("=L", _recv_exact(conn, 4))
            piece = pickle.loads(_recv_exact(conn, ln))
            imgutil.redraw_image(piece, canvas)
            conn.sendall(ACK)
    return canvas


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        buf += chunk
    return buf
