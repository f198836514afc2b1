"""Encoders (PyTorch port of the JAX package's models/encoder.py): the
SOMA-DSCN live-path encoder (module_original/encoder_dscn.py:9-44),
(B, 3, 240, 240) -> (B, 128, 30, 30), an 8x spatial downsample with PE
gates between the blocks, and the GDN-ResNet CSI / PE variants
(module_original/encoder_seq_shared_only.py:11-50). NCHW. Each forward
runs its convolutions under ``fp32_convs()``; a caller that takes a
gradient holds that context over its backward too."""

from __future__ import annotations

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.afb import AFBPE, AFBcsi
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.rcb import RCB, RCBGDN


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

    def forward(self, r: torch.Tensor, label: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        with fp32_convs():
            s = self.attention1(self.convBlock1(r, train), label)
            s = self.attention2(self.convBlock2(s, train), label)
            s = self.attention3(self.convBlock3(s, train), label)
            return self.convBlock4(s, train)


class _GDNEncoder(nn.Module):
    """4 RCBGDN blocks with a gate after each of the first three."""

    def __init__(self, gate, compressed_channel: int, input_channel: int):
        super().__init__()
        self.convBlock1 = RCBGDN(input_channel, 128, 2)
        self.attention1 = gate(128)
        self.convBlock2 = RCBGDN(128, 256, 2)
        self.attention2 = gate(256)
        self.convBlock3 = RCBGDN(256, 256, 2)
        self.attention3 = gate(256)
        self.convBlock4 = RCBGDN(256, compressed_channel, 1)

    def forward(self, r: torch.Tensor, sub_csi: torch.Tensor | None = None) -> torch.Tensor:
        with fp32_convs():
            s = self.attention1(self.convBlock1(r), sub_csi)
            s = self.attention2(self.convBlock2(s), sub_csi)
            s = self.attention3(self.convBlock3(s), sub_csi)
            return self.convBlock4(s)


class EncoderCSI(_GDNEncoder):
    """GDN-ResNet encoder with complex-CSI attention (AFBcsi gates)."""

    def __init__(self, csi_shape: int = 1, compressed_channel: int = 128):
        super().__init__(lambda c: AFBcsi(csi_shape, c), compressed_channel, 3)


class EncoderPE(_GDNEncoder):
    """GDN-ResNet encoder with PE attention: the shared encoder of
    SOMANet_PE.py:43-44."""

    def __init__(self, compressed_channel: int = 128, input_channel: int = 3):
        super().__init__(AFBPE, compressed_channel, input_channel)
