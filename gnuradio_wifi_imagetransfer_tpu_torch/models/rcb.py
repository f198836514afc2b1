"""Residual conv blocks of the live SOMA-DSCN pair (PyTorch port of the JAX
package's models/rcb.py):

  * RCB  - MobileNetV3-style depthwise encoder block (RCB_DS.py:20-79)
  * RTCB - transposed-conv ResNet block with IGDN (RTCB.py:6-42)

NCHW. The submodules carry the JAX package's names (conv1, bn1, ...,
convt1, gdn1, ...), so a checkpoint's leaf path is the state_dict key.
The JAX package emulates torch's ConvTranspose2d(k, stride, padding=pad,
output_padding=stride - 1) with lax.conv_transpose; here it is that op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import GDN, SeModule


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


class RCB(nn.Module):
    """expand (1x1) -> depthwise (kxk, stride) -> pointwise (1x1), BN +
    hard-swish, with the three skip variants of RCB_DS.py:44-67. The
    depthwise convolutions pad 1 on both sides at any stride, as the
    reference's torch padding=1 does."""

    def __init__(self, kernel_size: int = 3, in_size: int = 3, expand_size: int = 96,
                 out_size: int = 128, stride: int = 1, se: bool = False):
        super().__init__()
        k, s = kernel_size, stride
        self.conv1 = nn.Conv2d(in_size, expand_size, 1, bias=False)
        self.bn1 = _bn(expand_size)
        self.conv2 = nn.Conv2d(expand_size, expand_size, k, stride=s, padding=1,
                               groups=expand_size, bias=False)
        self.bn2 = _bn(expand_size)
        self.semodule = SeModule(expand_size) if se else None
        self.conv3 = nn.Conv2d(expand_size, out_size, 1, bias=False)
        self.bn3 = _bn(out_size)
        self.skip = "identity"
        if s == 1 and in_size != out_size:
            self.skip = "pointwise"
            self.skip_conv0 = nn.Conv2d(in_size, out_size, 1, bias=False)
            self.skip_bn0 = _bn(out_size)
        elif s == 2 and in_size != out_size:
            self.skip = "depthwise+pointwise"
            self.skip_conv0 = nn.Conv2d(in_size, in_size, 3, stride=2, padding=1,
                                        groups=in_size, bias=False)
            self.skip_bn0 = _bn(in_size)
            self.skip_conv1 = nn.Conv2d(in_size, out_size, 1, bias=True)
            self.skip_bn1 = _bn(out_size)
        elif s == 2:
            self.skip = "depthwise"
            self.skip_conv0 = nn.Conv2d(in_size, in_size, 3, stride=2, padding=1,
                                        groups=in_size, bias=False)
            self.skip_bn0 = _bn(out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.hardswish(self.bn1(self.conv1(x)))
        out = F.hardswish(self.bn2(self.conv2(out)))
        if self.semodule is not None:
            out = self.semodule(out)
        out = self.bn3(self.conv3(out))
        skip = x
        if self.skip != "identity":
            skip = self.skip_bn0(self.skip_conv0(x))
        if self.skip == "depthwise+pointwise":
            skip = self.skip_bn1(self.skip_conv1(skip))
        return F.hardswish(out + skip)


def conv_transpose(in_ch: int, out_ch: int, kernel_size: int, stride: int,
                   pad: int) -> nn.ConvTranspose2d:
    """torch's ConvTranspose2d with output size = input size x stride (the
    JAX package's ConvTransposeTorch)."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                              output_padding=stride - 1)


class RTCB(nn.Module):
    """ConvT(3x3, s) -> IGDN -> PReLU -> ConvT(3x3, 1) -> IGDN, plus a
    ConvT(1x1, s) + IGDN shortcut when the shape changes; final PReLU."""

    def __init__(self, in_channel: int, out_channel: int, stride: int = 2):
        super().__init__()
        self.convt1 = conv_transpose(in_channel, out_channel, 3, stride, 1)
        self.gdn1 = GDN(out_channel, inverse=True)
        self.prelu1 = nn.PReLU(out_channel)
        self.convt2 = conv_transpose(out_channel, out_channel, 3, 1, 1)
        self.gdn2 = GDN(out_channel, inverse=True)
        self.shortcut = stride != 1 or in_channel != out_channel
        if self.shortcut:
            self.skip_convt = conv_transpose(in_channel, out_channel, 1, stride, 0)
            self.skip_gdn = GDN(out_channel, inverse=True)
        self.prelu_out = nn.PReLU(out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.prelu1(self.gdn1(self.convt1(x)))
        y = self.gdn2(self.convt2(y))
        z = self.skip_gdn(self.skip_convt(x)) if self.shortcut else x
        return self.prelu_out(y + z)
