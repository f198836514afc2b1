"""SOMANet: the end-to-end multi-user semantic superposition model (PyTorch
port of the JAX package's models/somanet.py; SOMANet_DSCN.py DMANet :33-214
and SOMANet_PE.py :33-156 of the reference).

A shared DSCN encoder and PE decoder around a physical superposition
channel, with learnable IRS phase shifts ``shared_phi``. Two forward paths:

  * ``forward`` - the simple path (SOMANet_DSCN.py:97-144): encode each
    user, flatten + complexify (first half real / second half imag),
    sum-superpose, power-normalize, then per-user decode of the shared
    signal (the PE labels resolve the multiplexing).
  * ``forward_physics`` - the IRS physics path (_forward_old :146-214):
    per-user power-normalized complex symbols propagate through the IRS,
    sum, reflect by diag(Psi), reach each receiver, take AWGN, are
    zero-forced by the 1 x 1 CSI and decoded.

Images are NCHW per user, (U, B, 3, H, W). The latent is flattened in the
JAX package's (h, w, c) order, which decides the pairs that complexify
makes, so both packages put the same features on the real and imaginary
parts. As in the JAX package, the encoder runs once per user with the
``train`` flag (BatchNorm sees B images a call and updates once a user)
and the decoder always runs without it. Noise comes from a
``torch.Generator`` or as a tensor of CN draws, so a test can pass the
draws the JAX package makes.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.channel.sv import complex_normal
from gnuradio_wifi_imagetransfer_tpu_torch.models.decoder import DecoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.encoder import Encoder, EncoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import positionalencoding2d
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import GDN
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def power_norm(feature: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """The reference's powerNorm (SOMANet_DSCN.py:68-74): divide by the
    total per-sample power (not its square root, kept verbatim) and scale
    by sqrt(P * n). The power is re^2 + im^2, whose gradient is defined at
    0 (|z|^2 through |z| is not)."""
    mod = (feature.real ** 2 + feature.imag ** 2).sum(dim=1, keepdim=True)
    mod = torch.where(mod == 0, torch.full_like(mod, 1e-6), mod)
    weight = math.sqrt(float(np.float32(p * feature.shape[1])))
    return weight * feature / mod


def complexify(flat: torch.Tensor) -> torch.Tensor:
    """(..., 2n) real -> (..., n) complex: first half real, second imag
    (SOMANet_DSCN.py:112-114)."""
    n = flat.shape[-1] // 2
    return torch.complex(flat[..., :n], flat[..., n:])


def decomplexify(z: torch.Tensor) -> torch.Tensor:
    """(..., n) complex -> (..., 2n) real (SOMANet_DSCN.py:135-137)."""
    return torch.cat([z.real, z.imag], dim=-1)


def _flat_hwc(feats: torch.Tensor) -> torch.Tensor:
    """(..., c, h, w) -> (..., h * w * c) in the JAX package's NHWC order."""
    return feats.movedim(-3, -1).flatten(-3)


def _latent(flat: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    """(B, h * w * c) in (h, w, c) order -> (B, c, h, w), L2-normalised over
    the channels (floor 1e-12). Contiguous: torch's CPU backward of the
    decoder's transposed convolutions corrupts the heap on the permuted
    (channels-last) view."""
    r = flat.reshape(flat.shape[0], h, w, c)
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-12)
    return r.permute(0, 3, 1, 2).contiguous()


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module`` from ``generator`` with the JAX package's
    initialisers: Flax's lecun_normal (a normal of std sqrt(1 / fan_in) /
    0.8796, truncated at 2 std) for conv and dense kernels, xavier_uniform
    for transposed-conv kernels, zero biases, BatchNorm scale 1, PReLU
    0.25, GDN's identity-plus-pedestal. Draws in module order on the CPU."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and not isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.weight.data.copy_(w)
        elif isinstance(m, nn.ConvTranspose2d):
            w = torch.empty(m.weight.shape)
            nn.init.xavier_uniform_(w, generator=generator)
            m.weight.data.copy_(w)
        elif isinstance(m, nn.PReLU):
            m.weight.data.fill_(0.25)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, GDN):
            ch = m.beta.shape[0]
            m.beta.data.copy_(torch.sqrt(torch.ones(ch) + m.pedestal))
            m.gamma.data.copy_(torch.sqrt(0.1 * torch.eye(ch) + m.pedestal))
        if getattr(m, "bias", None) is not None and not isinstance(m, nn.BatchNorm2d):
            m.bias.data.zero_()
    return module


class _IRSModel(nn.Module):
    """What SOMANet and SOMANetPE share: the learnable IRS phases, drawn
    2 * 3.14 * U(0, 1) (SOMANet_DSCN.py:54-56), and the device."""

    def _setup(self, n_irs: int, seed: int, device):
        gen = torch.Generator().manual_seed(seed)
        flax_init_(self, gen)
        self.shared_phi = nn.Parameter(2 * 3.14 * torch.rand(n_irs, generator=gen))
        self.to(resolve(device))

    def psi(self) -> torch.Tensor:
        return torch.complex(torch.cos(self.shared_phi), torch.sin(self.shared_phi))


class SOMANet(_IRSModel):
    """Multi-user joint source-channel model with a shared encoder and
    decoder. Inputs are batched per user: images (U, B, 3, H, W) and PE
    labels (U, 256), one label per user from its CSI coordinate. Runs on
    ``device`` ("cuda" unless the caller asks for the CPU); ``seed`` seeds
    the initialisation."""

    def __init__(self, compressed_channel: int = 128, img_size: int = 240, n_irs: int = 16,
                 p: float = 1.0, seed: int = 0, device="cuda"):
        super().__init__()
        self.compressed_channel, self.img_size, self.n_irs, self.p = (
            compressed_channel, img_size, n_irs, p)
        self.shared_encoder = Encoder(compressed_channel=compressed_channel)
        self.shared_decoder = DecoderPE(compressed_channel=compressed_channel,
                                        reconstruct_channel=3)
        self._setup(n_irs, seed, device)

    def get_chnl(self, env_tx: torch.Tensor, env_rx: torch.Tensor) -> torch.Tensor:
        """CSI = env_rx^T diag(Psi) env_tx (SOMANet_DSCN.py getChnl :81-86)."""
        return env_rx.T @ (self.psi()[:, None] * env_tx)

    def _encode_users(self, images, labels, train: bool) -> torch.Tensor:
        return torch.stack([self.shared_encoder(images[u], labels[u], train)
                            for u in range(images.shape[0])])      # (U, B, c, h, w)

    def forward(self, images: torch.Tensor, labels: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """Simple superposition forward (SOMANet_DSCN.py:97-144)."""
        feats = self._encode_users(images, labels, train)
        c, h, w = feats.shape[2:]
        z = complexify(_flat_hwc(feats))                           # (U, B, n)
        mssv = power_norm(z.sum(dim=0), self.p)                    # (B, n)
        recv = _latent(decomplexify(mssv), h, w, c)
        return torch.stack([self.shared_decoder(recv, labels[u])
                            for u in range(labels.shape[0])])      # (U, B, 3, H, W)

    def forward_physics(self, images: torch.Tensor, labels: torch.Tensor,
                        envs_tx: torch.Tensor, envs_rx: torch.Tensor,
                        noise: Optional[torch.Generator | torch.Tensor] = None,
                        snr_db: float = 20.0, train: bool = False) -> torch.Tensor:
        """Full IRS propagation forward (_forward_old :146-214).

        envs_tx, envs_rx: (U, N, 1) per-user uplink and downlink channels.
        noise: None (no AWGN), a generator, or (U, B, n) CN draws of unit
        variance per part, scaled here by sigma / sqrt(2) with sigma =
        10^(-snr_db / 10) * P.
        """
        u, b = images.shape[:2]
        feats = self._encode_users(images, labels, train)
        c, h, w = feats.shape[2:]
        s = power_norm(complexify(_flat_hwc(feats)).reshape(u * b, -1), self.p)
        s = s.reshape(u, b, -1)                                    # (U, B, n)
        psi = self.psi()
        up = torch.einsum("un,ubm->nbm", envs_tx[..., 0], s)       # (N, B, n)
        reflected = psi[:, None, None] * up                        # diag(Psi) @ .
        if isinstance(noise, torch.Generator):
            noise = complex_normal(noise, (u, b, s.shape[-1]), s.device)
        sigma = 10.0 ** (-snr_db / 10.0) * self.p
        outs = []
        for ui in range(u):
            recv = torch.einsum("n,nbm->bm", envs_rx[ui, :, 0], reflected)   # (B, n)
            if noise is not None:
                recv = recv + noise[ui] * (sigma / np.sqrt(2))
            recv = recv / self.get_chnl(envs_tx[ui], envs_rx[ui])[0, 0]      # zero-forcing
            outs.append(self.shared_decoder(_latent(decomplexify(recv), h, w, c), labels[ui]))
        return torch.stack(outs)


def pe_labels(csi_keys: list[str], csi_bound: int = 30) -> np.ndarray:
    """PE labels (U, 256) from 're-im' CSI keys (SOMANet_DSCN.py:105-111)."""
    pe = positionalencoding2d(256, 2 * csi_bound, 2 * csi_bound)
    out = []
    for k in csi_keys:
        re, im = k.split("-")
        w = int(np.clip(round(float(re)) + csi_bound, 0, 2 * csi_bound - 1))
        h = int(np.clip(round(float(im)) + csi_bound, 0, 2 * csi_bound - 1))
        out.append(pe[:, w, h])
    return np.stack(out)


class SOMANetPE(_IRSModel):
    """SOMANet_PE variant (SOMANet_PE.py DMANet :33-156): GDN-ResNet
    EncoderPE / DecoderPE around the always-on IRS physics path. Users are
    scheduled as (tx, rx) channel-index pairs into a bank of K environment
    vectors; each pair's PE label is looked up from the CSI that the pair's
    own channels produce. As in the JAX package, the reflection applies
    diag(Psi) to the IRS-summed signal, where the reference broadcasts Psi
    row-wise (SOMANet_PE.py:126-128)."""

    def __init__(self, compressed_channel: int = 128, img_size: int = 240, n_irs: int = 16,
                 p: float = 1.0, csi_bound: int = 30, snr_db: float = 20.0, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.compressed_channel, self.img_size, self.n_irs, self.p = (
            compressed_channel, img_size, n_irs, p)
        self.csi_bound, self.snr_db = csi_bound, snr_db
        self.shared_encoder = EncoderPE(compressed_channel=compressed_channel)
        self.shared_decoder = DecoderPE(compressed_channel=compressed_channel,
                                        reconstruct_channel=3)
        self.register_buffer("pe_table", torch.from_numpy(
            positionalencoding2d(256, 2 * csi_bound, 2 * csi_bound)), persistent=False)
        self._setup(n_irs, seed, device)

    def get_chnl(self, env_tx: torch.Tensor, env_rx: torch.Tensor) -> torch.Tensor:
        """CSI = env_tx^T diag(Psi) env_rx (SOMANet_PE.py:80-85)."""
        return env_tx.T @ (self.psi()[:, None] * env_rx)

    def _pe_label(self, csi: torch.Tensor) -> torch.Tensor:
        """PE[:, w, h] with w / h = clip(round(Re / Im CSI) + bound); no
        gradient flows through the index (the reference detaches)."""
        b = self.csi_bound
        csi = csi.detach()
        w = torch.clamp(torch.round(csi.real) + b, 0, 2 * b - 1).to(torch.int64)
        h = torch.clamp(torch.round(csi.imag) + b, 0, 2 * b - 1).to(torch.int64)
        return self.pe_table[:, w, h]

    def forward(self, images: torch.Tensor, pairs, envs: torch.Tensor,
                noise: Optional[torch.Generator | torch.Tensor] = None) -> torch.Tensor:
        """images (U, B, 3, H, W); pairs (U, 2) indices into envs (K, N, 1);
        noise as in SOMANet.forward_physics. Returns (U, B, 3, H, W)."""
        u, b = images.shape[:2]
        pairs = [(int(t), int(r)) for t, r in np.asarray(pairs)]
        psi = self.psi()
        signals, labels = [], []
        for ui, (tx, rx) in enumerate(pairs):
            label = self._pe_label(self.get_chnl(envs[tx], envs[rx])[0, 0])
            labels.append(label)
            feature = self.shared_encoder(images[ui], label)
            signals.append(power_norm(complexify(_flat_hwc(feature)), self.p))   # (B, n)
        env_tx = torch.stack([envs[tx, :, 0] for tx, _ in pairs])               # (U, N)
        reflected = psi[:, None, None] * torch.einsum("un,ubm->nbm", env_tx,
                                                      torch.stack(signals))
        if isinstance(noise, torch.Generator):
            noise = complex_normal(noise, (u,) + signals[0].shape, reflected.device)
        sigma = 10.0 ** (-self.snr_db / 10.0) * self.p
        hs = self.img_size // 8
        outs = []
        for ui, (tx, rx) in enumerate(pairs):
            recv = torch.einsum("n,nbm->bm", envs[rx, :, 0], reflected)
            if noise is not None:
                recv = recv + noise[ui] * (sigma / np.sqrt(2))
            recv = recv / self.get_chnl(envs[tx], envs[rx])[0, 0]
            r = _latent(decomplexify(recv), hs, hs, self.compressed_channel)
            outs.append(self.shared_decoder(r, labels[ui]))
        return torch.stack(outs)
