"""The SOMA-DSCN live-path encoder (PyTorch port of the JAX package's
models/encoder.py ``Encoder``, module_original/encoder_dscn.py:9-44):
(B, 3, 240, 240) -> (B, 128, 30, 30), an 8x spatial downsample, with PE
gates between the blocks. NCHW."""

from __future__ import annotations

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.afb import AFBPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.rcb import RCB


class Encoder(nn.Module):
    def __init__(self, compressed_channel: int = 128, input_channel: int = 3):
        super().__init__()
        self.convBlock1 = RCB(3, input_channel, 96, 128, stride=2)
        self.attention1 = AFBPE(128)
        self.convBlock2 = RCB(3, 128, 256, 256, stride=2)
        self.attention2 = AFBPE(256)
        self.convBlock3 = RCB(3, 256, 512, 256, stride=2)
        self.attention3 = AFBPE(256)
        self.convBlock4 = RCB(3, 256, 256, compressed_channel, stride=1)

    def forward(self, r: torch.Tensor, label: torch.Tensor | None = None) -> torch.Tensor:
        with fp32_convs():
            s = self.attention1(self.convBlock1(r), label)
            s = self.attention2(self.convBlock2(s), label)
            s = self.attention3(self.convBlock3(s), label)
            return self.convBlock4(s)
