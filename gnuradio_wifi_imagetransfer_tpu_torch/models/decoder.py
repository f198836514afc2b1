"""SOMA-DSCN decoders (PyTorch port of the JAX package's models/decoder.py,
module_original/decoder_seq_shared_only.py, decoder_dscn.py and
decoder_original.py): (B, 128, 30, 30) -> (B, 3, 240, 240). NCHW.

  * DecoderPE       - 4 RTCB blocks with PE gates (:33-53, the live path)
  * Decoder         - the same with CSI gates (:10-30)
  * DecoderSA       - no gates (:55-68)
  * DecoderDSCN     - 4 RTCBDS blocks with PE gates (decoder_dscn.py:10-44)
  * DecoderOriginal - RTCB blocks with fixed-SNR gates
                      (decoder_original.py:10-29)

Each forward runs its convolutions under ``fp32_convs()``.
"""

from __future__ import annotations

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.afb import AFB, AFBPE, AFBcsi
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.rcb import RTCB, RTCBDS


class _RTCBDecoder(nn.Module):
    """RTCB(c -> 256, 1), RTCB(256 -> 256, 2), RTCB(256 -> 128, 2),
    RTCB(128 -> out, 2), with a gate after each of the first three when
    ``gate`` is given."""

    def __init__(self, gate, compressed_channel: int, reconstruct_channel: int):
        super().__init__()
        self.convBlock1 = RTCB(compressed_channel, 256, 1)
        self.convBlock2 = RTCB(256, 256, 2)
        self.convBlock3 = RTCB(256, 128, 2)
        self.convBlock4 = RTCB(128, reconstruct_channel, 2)
        if gate is not None:
            self.attention1 = gate(256)
            self.attention2 = gate(256)
            self.attention3 = gate(128)

    def forward(self, s: torch.Tensor, sub_csi: torch.Tensor | None = None) -> torch.Tensor:
        with fp32_convs():
            r = self.attention1(self.convBlock1(s), sub_csi)
            r = self.attention2(self.convBlock2(r), sub_csi)
            r = self.attention3(self.convBlock3(r), sub_csi)
            return self.convBlock4(r)


class DecoderPE(_RTCBDecoder):
    def __init__(self, compressed_channel: int = 128, reconstruct_channel: int = 3):
        super().__init__(AFBPE, compressed_channel, reconstruct_channel)


class Decoder(_RTCBDecoder):
    """The AFBcsi-conditioned variant."""

    def __init__(self, csi_shape: int = 1, compressed_channel: int = 128,
                 reconstruct_channel: int = 3):
        super().__init__(lambda c: AFBcsi(csi_shape, c), compressed_channel,
                         reconstruct_channel)


class DecoderSA(_RTCBDecoder):
    """The attention-free variant."""

    def __init__(self, compressed_channel: int = 128, reconstruct_channel: int = 3):
        super().__init__(None, compressed_channel, reconstruct_channel)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        with fp32_convs():
            r = self.convBlock2(self.convBlock1(s))
            return self.convBlock4(self.convBlock3(r))


class DecoderDSCN(nn.Module):
    """Depthwise-separable transposed decoder: 4 RTCBDS blocks + PE gates."""

    def __init__(self, compressed_channel: int = 128, reconstruct_channel: int = 3):
        super().__init__()
        self.convBlock1 = RTCBDS(3, compressed_channel, 256, 256, 2)
        self.attention1 = AFBPE(256)
        self.convBlock2 = RTCBDS(3, 256, 512, 256, 2)
        self.attention2 = AFBPE(256)
        self.convBlock3 = RTCBDS(3, 256, 256, 128, 2)
        self.attention3 = AFBPE(128)
        self.convBlock4 = RTCBDS(3, 128, 96, reconstruct_channel, 1)

    def forward(self, s: torch.Tensor, sub_csi: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        with fp32_convs():
            r = self.attention1(self.convBlock1(s, train), sub_csi)
            r = self.attention2(self.convBlock2(r, train), sub_csi)
            r = self.attention3(self.convBlock3(r, train), sub_csi)
            return self.convBlock4(r, train)


class DecoderOriginal(nn.Module):
    """Fixed-SNR-conditioned decoder: RTCB + AFB(SNR) stack."""

    def __init__(self, snr: float = 20.0, compressed_channel: int = 128,
                 reconstruct_channel: int = 3):
        super().__init__()
        self.snr = snr
        self.rtcb1 = RTCB(compressed_channel, 256, 1)
        self.afb1 = AFB(256)
        self.rtcb2 = RTCB(256, 256, 2)
        self.afb2 = AFB(256)
        self.rtcb3 = RTCB(256, 128, 2)
        self.afb3 = AFB(128)
        self.rtcb4 = RTCB(128, reconstruct_channel, 2)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        with fp32_convs():
            r = self.afb1(self.snr, self.rtcb1(s))
            r = self.afb2(self.snr, self.rtcb2(r))
            r = self.afb3(self.snr, self.rtcb3(r))
            return self.rtcb4(r)
