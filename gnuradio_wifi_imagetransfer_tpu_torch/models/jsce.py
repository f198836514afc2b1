"""JSCE facade: images <-> one superposed latent feature map (PyTorch port
of the JAX package's models/jsce.py, codec/jsce_codec.py:61-144 of the
reference; the Mode-1 live inference path).

The SOMA-DSCN encoder and PE decoder run on ``device`` ("cuda" unless the
caller asks for the CPU) in NCHW; the facade's inputs and outputs keep the
JAX package's layouts: HWC images, and the (h, w, c) float32 latent that
the Mode-1 apps cut into pieces. Each user's 2-D sin/cos positional
encoding, indexed by its "re-im" key clamped to +-csi_bound, conditions
the gates; img2msg averages the users' latents, msg2img L2-normalises the
channel dim (floor 1e-12), decodes with one user's label, denormalises,
clamps and rounds to uint8.

The forward runs in float32 with TF32 off and deterministic cuDNN
algorithms (``layers.fp32_convs``), so the card's latent matches the CPU
path's to float32 rounding. On a card the encode (one user's image and
label -> its latent) and the decode (the latent and a label -> the HWC
reconstruction, the L2 normalisation inside) are CUDA graphs
(``self.graphs``, keyed by geometry), as the JAX package jits its
``_enc_apply`` and ``_dec_apply``; each user's label is uploaded once and
kept on the device, a graph input. The first call of each on a card
loads its kernels and captures its graph: ``warm()`` makes both before a
caller that must not stall (a radio's receive thread) starts.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.models.decoder import DecoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.encoder import Encoder
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.graphs import GraphCache
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
TARGET = ("3-4", "13-10")            # the reference's Mode-1 users (upload_featuremap_udp.py:22)


def positionalencoding2d(d_model: int, height: int, width: int) -> np.ndarray:
    """2-D sin/cos positional encoding (jsce_codec.py:34-57): channels
    [0:d/2] encode the width coordinate, [d/2:] the height coordinate.
    Returns (d_model, height, width) float32."""
    if d_model % 4 != 0:
        raise ValueError(f"d_model must be divisible by 4, got {d_model}")
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(width, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div).T[:, :, None].repeat(width, axis=2)
    return pe


def denormalize(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization; img (..., H, W, C)."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 or float [0, 1] HWC -> ImageNet-normalized float32."""
    img = np.asarray(img, dtype=np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class JSCE:
    """Inference facade with the reference's API (img2msg / msg2img)."""

    @classmethod
    def packaged(cls, **overrides) -> "JSCE":
        """The facade around the trained packaged checkpoint (geometry from
        its metadata), as the reference loads its default checkpoint
        (upload_featuremap_udp.py:78-82). Raises FileNotFoundError if there
        is none; ``GWT_JSCE_WEIGHTS`` names another file."""
        path = wt.default_checkpoint()
        if path is None:
            raise FileNotFoundError("no packaged JSCE checkpoint; run make_weights.py or set "
                                    "GWT_JSCE_WEIGHTS")
        _, meta = wt.load_soma_npz(path)
        size = int(meta.get("img_size", 80))
        kwargs = dict(weight_path=path, img_size=(size, size),
                      compressed_channel=int(meta.get("compressed_channel", 64)))
        kwargs.update(overrides)
        return cls(**kwargs)

    def __init__(
        self,
        weight_path: Optional[str] = None,
        img_size: tuple[int, int] = (240, 240),
        compressed_channel: int = 128,
        csi_bound: int = 30,
        codec: str = "SOMA-DSCN",
        params=None,
        rng_seed: int = 0,
        device="cuda",
    ):
        """``params``: (encoder, decoder) Flax variables trees (numpy or any
        array numpy reads), carried into the modules; else the checkpoint at
        ``weight_path`` (an npz of make_weights.py, or the reference's .pth
        through ``convert``); else a random init from ``torch.Generator`` seeded
        with ``rng_seed`` (it cannot give the JAX package's numbers)."""
        if codec != "SOMA-DSCN":
            raise NotImplementedError(
                "the reference's live path instantiates codec='SOMA-DSCN' "
                "(upload_featuremap_udp.py:78-82)")
        self.device = resolve(device)
        self.img_size = tuple(img_size)
        self.c = compressed_channel
        self.csi_bound = csi_bound
        self.encoder = Encoder(compressed_channel=compressed_channel)
        self.decoder = DecoderPE(compressed_channel=compressed_channel, reconstruct_channel=3)
        # PE table (256, 2*bound, 2*bound), indexed [channel, w, h]
        self.pe = positionalencoding2d(256, 2 * csi_bound, 2 * csi_bound)

        if params is None and weight_path is not None and str(weight_path).endswith(".npz"):
            # the native checkpoint that make_weights.py trains
            variables, meta = wt.load_soma_npz(weight_path)
            if meta.get("compressed_channel", compressed_channel) != compressed_channel:
                raise ValueError(f"checkpoint has compressed_channel="
                                 f"{meta['compressed_channel']}, facade asked for "
                                 f"{compressed_channel}")
            params = wt.split_soma(variables)
        elif params is None and weight_path is not None:
            # a reference-format .pth (jsce_codec.py:89-96)
            from gnuradio_wifi_imagetransfer_tpu_torch.models import convert

            params = convert.load_torch_checkpoint(weight_path)
        if params is not None:
            for m, variables in zip((self.encoder, self.decoder), params):
                m.load_state_dict(wt.state_dict_from_flax(variables, m))
        else:
            gen = torch.Generator().manual_seed(rng_seed)
            for m in (self.encoder, self.decoder):
                for name, p in m.named_parameters():
                    if name.endswith("weight") and p.dim() > 1:
                        torch.nn.init.kaiming_uniform_(p.data, a=math.sqrt(5), generator=gen)
                    elif name.endswith("bias"):
                        p.data.zero_()
        for m in (self.encoder, self.decoder):
            m.eval().requires_grad_(False).to(self.device)
        self.graphs = GraphCache()
        self._labels: dict[str, torch.Tensor] = {}

    # -- reference API ----------------------------------------------------

    def get_csi(self, key: str) -> complex:
        """'re-im' -> complex (jsce_codec.py:98-100)."""
        real, imag = key.split("-")
        return complex(float(real), float(imag))

    def _label(self, user_key: str) -> torch.Tensor:
        """The user's PE label (256,) on the device, uploaded at its first
        use and kept."""
        label = self._labels.get(user_key)
        if label is None:
            csi = self.get_csi(user_key)
            b = self.csi_bound
            w = int(np.clip(round(csi.real) + b, 0, 2 * b - 1))
            h = int(np.clip(round(csi.imag) + b, 0, 2 * b - 1))
            label = torch.from_numpy(np.ascontiguousarray(self.pe[:, w, h])).to(self.device)
            self._labels[user_key] = label
        return label

    def _preprocess(self, img) -> np.ndarray:
        """Resize (a PIL image) and ImageNet-normalize. The reference's
        inference-time RandomGrayscale(p=0.1) is dropped, as in the JAX
        package, for deterministic inference."""
        from PIL import Image

        if isinstance(img, Image.Image):
            img = np.asarray(img.convert("RGB").resize((self.img_size[1], self.img_size[0])))
        img = np.asarray(img)
        if img.shape[:2] != self.img_size:
            raise ValueError(f"expected {self.img_size} image, got {img.shape}")
        return normalize_image(img)

    def encode(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """One user's normalised HWC image (H, W, 3) float32 and label (256,)
        -> its latent (1, c, h, w): what the encode graph captures."""
        return self.encoder(x.permute(2, 0, 1)[None], label)

    def decode(self, latent: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """The (h, w, c) float32 latent, L2-normalised over c (floor 1e-12),
        and a label (256,) -> the (H, W, 3) reconstruction, still
        ImageNet-normalised: what the decode graph captures."""
        x = latent / torch.clamp(torch.linalg.vector_norm(latent, dim=-1, keepdim=True),
                                 min=1e-12)
        return self.decoder(x.permute(2, 0, 1)[None], label)[0].permute(1, 2, 0)

    def _run(self, name: str, fn, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """fn(x, label): a replay of its graph (keyed by name and geometry)
        on a card, eager on the CPU."""
        if x.device.type == "cuda":
            return self.graphs((name, tuple(x.shape)), fn, (x, label))
        return fn(x, label)

    @torch.inference_mode()
    def img2msg(self, image_dict: dict) -> np.ndarray:
        """{user_key: HWC image} -> (h, w, c) float32 mean-superposed latent
        (jsce_codec.py:102-121)."""
        latents = []
        for key, img in image_dict.items():
            x = torch.from_numpy(self._preprocess(img)).to(self.device)
            lat = self._run("encode", self.encode, x, self._label(key))      # (1, c, h, w)
            latents.append(lat[0].permute(1, 2, 0))
        return torch.stack(latents).mean(dim=0).cpu().numpy().astype(np.float32)

    @torch.inference_mode()
    def msg2img(self, latent: np.ndarray, user_id: str):
        """(h, w, c) latent -> the user's reconstructed PIL image
        (jsce_codec.py:123-144)."""
        x = torch.from_numpy(np.array(latent, dtype=np.float32)).to(self.device)
        rec = self._run("decode", self.decode, x, self._label(user_id))
        rec = np.clip(denormalize(rec.cpu().numpy()), 0.0, 1.0)
        from PIL import Image

        return Image.fromarray((rec * 255.0 + 0.5).astype(np.uint8))

    def warm(self) -> "JSCE":
        """One img2msg and one msg2img at this geometry on blank inputs: on a
        card they load the kernels, choose the cuDNN algorithms and capture
        the encode and decode graphs, which a caller on a radio's receive
        thread must not wait for."""
        blank = np.zeros(self.img_size + (3,), np.uint8)
        latent = self.img2msg({u: blank for u in TARGET})
        self.msg2img(latent, TARGET[0])
        return self
