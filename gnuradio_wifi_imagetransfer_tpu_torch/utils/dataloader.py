"""Recursive image-folder dataset (PyTorch port of the JAX package's
utils/dataloader.py, the reference's utils/dataloader.py ImagenetMini).

The reference wraps torchvision; here a numpy/PIL loader that yields
ImageNet-normalized NHWC batches, which the trainer takes as they are.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import normalize_image

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class ImageFolderDataset:
    """Recursively collects images under ``root`` (dataloader.py:7-35)."""

    def __init__(self, root: str, img_size: tuple[int, int] = (240, 240)):
        self.root = root
        self.img_size = img_size
        self.paths = sorted(
            os.path.join(dp, f)
            for dp, _, files in os.walk(root)
            for f in files
            if f.lower().endswith(IMAGE_EXTS)
        )
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.paths[idx]) as img:
            img = img.convert("RGB").resize((self.img_size[1], self.img_size[0]))
        return normalize_image(np.asarray(img))

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True) -> Iterator[np.ndarray]:
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idxs = order[i : i + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            yield np.stack([self[j] for j in idxs])
