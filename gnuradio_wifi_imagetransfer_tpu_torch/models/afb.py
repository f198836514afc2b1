"""Positional-encoding-conditioned channel gate (PyTorch port of the JAX
package's models/afb.py ``AFBPE``, AFB.py:57-78): squeeze (spatial mean),
add the first C entries of the user's PE label, FC -> ReLU -> FC ->
sigmoid, per-channel gate. NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class AFBPE(nn.Module):
    def __init__(self, channel_size: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channel_size, channel_size)
        self.fc2 = nn.Linear(channel_size, channel_size)

    def forward(self, feature: torch.Tensor, label: torch.Tensor | None = None) -> torch.Tensor:
        x = feature.mean(dim=(2, 3))                              # (B, C)
        if label is not None:
            x = x + label[: x.shape[1]][None, :]
        x = torch.sigmoid(self.fc2(F.relu(self.fc1(x))))
        return feature * x[:, :, None, None]
