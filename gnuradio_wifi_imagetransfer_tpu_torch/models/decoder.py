"""The PE-conditioned decoder of the live path (PyTorch port of the JAX
package's models/decoder.py ``DecoderPE``,
module_original/decoder_seq_shared_only.py:33-53): 4 RTCB blocks with PE
gates, (B, 128, 30, 30) -> (B, 3, 240, 240). NCHW."""

from __future__ import annotations

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.afb import AFBPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.rcb import RTCB


class DecoderPE(nn.Module):
    def __init__(self, compressed_channel: int = 128, reconstruct_channel: int = 3):
        super().__init__()
        self.convBlock1 = RTCB(compressed_channel, 256, 1)
        self.attention1 = AFBPE(256)
        self.convBlock2 = RTCB(256, 256, 2)
        self.attention2 = AFBPE(256)
        self.convBlock3 = RTCB(256, 128, 2)
        self.attention3 = AFBPE(128)
        self.convBlock4 = RTCB(128, reconstruct_channel, 2)

    def forward(self, s: torch.Tensor, label: torch.Tensor | None = None) -> torch.Tensor:
        with fp32_convs():
            r = self.attention1(self.convBlock1(s), label)
            r = self.attention2(self.convBlock2(r), label)
            r = self.attention3(self.convBlock3(r), label)
            return self.convBlock4(r)
