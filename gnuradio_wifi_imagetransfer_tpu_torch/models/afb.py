"""Attention-feature blocks: SNR-, CSI- and PE-conditioned channel gates
(PyTorch port of the JAX package's models/afb.py, AFB.py:6-78): squeeze
(spatial mean), condition injection, FC -> ReLU -> FC -> sigmoid,
per-channel gate. NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _gate(block, feature: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    x = torch.sigmoid(block.fc2(F.relu(block.fc1(x))))
    return feature * x[:, :, None, None]


class AFB(nn.Module):
    """SNR-conditioned gate (AFB.py:6-23): the scalar SNR joins the channel
    means."""

    def __init__(self, channel_size: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channel_size + 1, channel_size)
        self.fc2 = nn.Linear(channel_size, channel_size)

    def forward(self, snr, feature: torch.Tensor) -> torch.Tensor:
        x = feature.mean(dim=(2, 3))                              # (B, C)
        snr = torch.as_tensor(snr, dtype=x.dtype, device=x.device).reshape(-1, 1)
        return _gate(self, feature, torch.cat([x, snr.expand(x.shape[0], 1)], dim=1))


class AFBcsi(nn.Module):
    """Complex-CSI-conditioned gate (AFB.py:26-54): the CSI's ``append_size``
    complex entries, as [real, imag], through two linear maps join the
    channel means. The JAX package infers the linear maps' inputs at its
    first call; here they are fixed, so a call must carry the CSI."""

    def __init__(self, append_size: int = 1, channel_size: int = 128):
        super().__init__()
        self.complex2float = nn.Linear(2 * append_size, 2 * append_size)
        self.irs_compress = nn.Linear(2 * append_size, channel_size)
        self.fc1 = nn.Linear(2 * channel_size, channel_size)
        self.fc2 = nn.Linear(channel_size, channel_size)

    def forward(self, feature: torch.Tensor, sub_csi: torch.Tensor) -> torch.Tensor:
        x = feature.mean(dim=(2, 3))
        csi = torch.cat([sub_csi.real.reshape(-1), sub_csi.imag.reshape(-1)])
        att = self.irs_compress(self.complex2float(csi.to(x.dtype)))
        return _gate(self, feature, torch.cat([x, att[None, :].expand(x.shape[0], -1)], dim=1))


class AFBPE(nn.Module):
    """Positional-encoding-conditioned gate (AFB.py:57-78): the first C
    entries of the user's PE label are added to the channel means."""

    def __init__(self, channel_size: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channel_size, channel_size)
        self.fc2 = nn.Linear(channel_size, channel_size)

    def forward(self, feature: torch.Tensor, label: torch.Tensor | None = None) -> torch.Tensor:
        x = feature.mean(dim=(2, 3))                              # (B, C)
        if label is not None:
            x = x + label[: x.shape[1]][None, :]
        return _gate(self, feature, x)
