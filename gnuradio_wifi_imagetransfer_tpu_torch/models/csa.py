"""CSA ("Channel-Spatial Attention") feature block (PyTorch port of the JAX
package's models/csa.py, codec/models/basic_blocks/CSA.py:8-33): like AFB,
but the SNR condition is fixed at construction, a scalar or a list
(multi-SNR), appended to the squeezed channel descriptor. NCHW; runs on
``device`` ("cuda" unless the caller asks for the CPU)."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


class CSAAFB(nn.Module):
    """squeeze -> concat fixed SNR(s) -> FC/ReLU/FC/sigmoid gate."""

    def __init__(self, snr: Union[float, Sequence[float]], channel_size: int = 128,
                 device="cuda"):
        super().__init__()
        snr = torch.from_numpy(np.atleast_1d(np.asarray(snr, np.float32)))
        self.register_buffer("snr", snr, persistent=False)
        self.fc1 = nn.Linear(channel_size + snr.shape[0], channel_size)
        self.fc2 = nn.Linear(channel_size, channel_size)
        self.to(resolve(device))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        x = feature.mean(dim=(2, 3))                              # (B, C)
        x = torch.cat([x, self.snr[None, :].expand(x.shape[0], -1)], dim=1)
        x = torch.sigmoid(self.fc2(F.relu(self.fc1(x))))
        return feature * x[:, :, None, None]
