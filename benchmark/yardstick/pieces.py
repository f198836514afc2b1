"""The radio cells' traffic: the reference's Mode-2 pieces of one image.

As the reference's ``upload_image_udp.py`` with ``image_detach_rebuild.py``
(and the port's utils/image.py) cut an image: (H, W, C) into (10, 10, 1)
pieces in a shuffled order, each sent as ``struct.pack("=L", len(p)) + p``
for ``p = pickle.dumps(((y, x, c), piece))``. The radio's sink strips the
4-byte prefix, so what arrives is ``p``. The image is drawn from the seed:
after scrambling, its content does not change the PHY's work. NumPy and
the standard library only.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np


def make_pieces(image_shape, piece_shape, seed: int) -> tuple[list[bytes], list[bytes]]:
    """(datagrams as sent, payloads as they arrive), one a piece, in the
    shuffled order of the sender."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x9E]))
    h, w, c = image_shape
    ph, pw = piece_shape
    image = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    pieces = [((y, x, ch), image[y: y + ph, x: x + pw, ch: ch + 1])
              for y in range(0, h, ph) for x in range(0, w, pw) for ch in range(c)]
    order = rng.permutation(len(pieces))
    payloads = [pickle.dumps(pieces[i]) for i in order]
    return [struct.pack("=L", len(p)) + p for p in payloads], payloads


def schedule(n: int, rate: float, pattern: str, burst: int = 1) -> np.ndarray:
    """Due times (s from the window's start) of n pieces at a mean
    ``rate``: "steady" at fixed spacing, "bursty" in bursts of ``burst``
    pieces due together, one burst every burst / rate seconds."""
    i = np.arange(n)
    if pattern == "steady":
        return i / rate
    if pattern == "bursty":
        return (i // burst) * (burst / rate)
    raise ValueError(f"unknown pattern {pattern!r}")
