"""ViT-based hierarchical codec (PyTorch port of the JAX package's
models/vit_codec.py): Swin-style patch merge/expand around CrossAttention
Transformer stages (codec/models/module_original/encoder_vit.py:11-59 and
decoder_vit.py:10-66). Token layout (B, H*W, C); the context (the PE/CSI
condition) is truncated to the stage width as the reference does. Every
public module runs on ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.swin import PatchExpand, PatchMerging
from gnuradio_wifi_imagetransfer_tpu_torch.models.vit import Transformer
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


class BasicLayer(nn.Module):
    """Transformer stage + optional PatchMerging downsample
    (encoder_vit.py:11-40)."""

    def __init__(self, img_size: int, patch_dim: int, depth: int = 6, num_heads: int = 16,
                 downsample: bool = True, device="cuda"):
        super().__init__()
        self.blocks = Transformer(patch_dim, depth, num_heads, 64, 512, device=device)
        self.downsample = (PatchMerging((img_size, img_size), patch_dim, device)
                           if downsample else None)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.blocks(x, context)
        return x if self.downsample is None else self.downsample(x)


class BasicLayerUp(nn.Module):
    """Optional PatchExpand upsample + Transformer stage
    (decoder_vit.py:10-40); the stage runs at patch_dim // 2 after an
    expand, as in the reference."""

    def __init__(self, img_size: int, patch_dim: int, depth: int = 6, num_heads: int = 16,
                 upsample: bool = True, device="cuda"):
        super().__init__()
        self.upsample = (PatchExpand((img_size, img_size), patch_dim, 2, device)
                         if upsample else None)
        dim = patch_dim // 2 if upsample else patch_dim
        self.blocks = Transformer(dim, depth, num_heads, 64, 512, device=device)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample is not None:
            x = self.upsample(x)
        return self.blocks(x, context)


class ViTEncoder(nn.Module):
    """Stacked BasicLayers, each halving the resolution
    (encoder_vit.py:43-59). The widths follow PatchMerging's output,
    patch_dim * 2^i (the reference's patch_dim * (i + 1) type-checks only
    at its one working depth, 2, where the two agree)."""

    def __init__(self, input_size: int, patch_dim: int, layer_depth: int = 2, device="cuda"):
        super().__init__()
        self.layer_depth = layer_depth
        for i in range(layer_depth):
            setattr(self, f"layer{i}", BasicLayer(input_size // 2**i, patch_dim * 2**i,
                                                  device=device))
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.layer_depth):
            ctx = None if context is None else context[:, :, : x.shape[2]]
            x = getattr(self, f"layer{i}")(x, ctx)
        return x


class ViTDecoder(nn.Module):
    """Stacked BasicLayerUps, each doubling the resolution
    (decoder_vit.py:49-66); mirror of ViTEncoder."""

    def __init__(self, input_size: int, patch_dim: int, layer_depth: int = 2, device="cuda"):
        super().__init__()
        self.layer_depth = layer_depth
        for i in range(layer_depth):
            setattr(self, f"layer{i}", BasicLayerUp(input_size * 2**i, patch_dim // 2**i,
                                                    device=device))
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.layer_depth):
            ctx = None if context is None else context[:, :, : x.shape[2] // 2]
            x = getattr(self, f"layer{i}")(x, ctx)
        return x
