"""Image patchization / reassembly and the UDP piece wire format (copy of
the JAX package's utils/image.py; numpy, pickle and struct only).

Reimplements image_detach_rebuild.py behaviorally: an (H, W, C) array is
sliced into per-channel piece_size blocks keyed by their (y, x, c) origin,
shuffled for erasure-tolerant progressive transfer (lost pieces are healed
on a later re-send lap); rebuild/redraw invert the slicing. Works for
uint8 images and float32 feature maps alike.

Wire format (upload_image_udp.py:28-31): each piece is pickled and
prefixed with a 4-byte native-endian ("=L") length; the receiver contract
(IRS_AP_epy_block_2.py:34-38) strips the 24-byte MAC header then this
4-byte prefix.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np

PIECE_SIZE = (10, 10)


def detach_image(image: np.ndarray, piece_size=PIECE_SIZE, rng=None):
    """Slice (H, W, C) into shuffled [((y, x, c), piece)] with per-channel
    (ph, pw, 1) pieces (image_detach_rebuild.py:6-32)."""
    height, width, channels = image.shape
    ph, pw = piece_size
    pieces = []
    for y in range(0, height, ph):
        for x in range(0, width, pw):
            for c in range(channels):
                pieces.append(((y, x, c), image[y : y + ph, x : x + pw, c : c + 1]))
    rng = np.random.default_rng() if rng is None else rng
    order = rng.permutation(len(pieces))
    return [pieces[i] for i in order]


def rebuild_image(pieces, image_size, piece_size=PIECE_SIZE, dtype=None):
    """Rebuild the full array from [((y, x, c), piece)]
    (image_detach_rebuild.py:34-56)."""
    ph, pw = piece_size
    if dtype is None:
        dtype = pieces[0][1].dtype if pieces else np.uint8
    out = np.zeros(image_size, dtype=dtype)
    for (y, x, c), piece in pieces:
        out[y : y + ph, x : x + pw, c : c + 1] = piece
    return out


def redraw_image(patch, canvas, piece_size=PIECE_SIZE):
    """In-place update of one piece in a persistent canvas
    (image_detach_rebuild.py:58-67)."""
    (y, x, c), piece = patch
    ph, pw = piece_size
    canvas[y : y + ph, x : x + pw, c : c + 1] = piece
    return canvas


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


def encode_piece(piece) -> bytes:
    """((y, x, c), array) -> length-prefixed pickle (the sender datagram)."""
    data = pickle.dumps(piece)
    return struct.pack("=L", len(data)) + data


def decode_piece(datagram: bytes):
    """Inverse of encode_piece; validates the length prefix. Unpickles, so
    only for datagrams of this program's own senders."""
    (n,) = struct.unpack("=L", datagram[:4])
    body = datagram[4 : 4 + n]
    if len(body) != n:
        raise ValueError(f"truncated piece: prefix says {n}, got {len(body)}")
    return pickle.loads(body)


def strip_transport(payload: bytes) -> bytes:
    """RX-side contract of the 'Extract Pics' block
    (IRS_AP_epy_block_2.py:34-38): drop the 4-byte length prefix from a
    MAC payload (the 24-byte MAC header is already removed by mac.parse)."""
    return payload[4:]
