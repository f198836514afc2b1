"""Swin-Transformer building blocks (PyTorch port of the JAX package's
models/swin.py, codec/models/basic_blocks/Swin_ViT.py:8-489): windowed
attention with relative position bias, shifted windows, and the patch
merge/expand resamplers.

Token layout (B, H*W, C), channels last as in the JAX package; only
``PatchEmbed`` takes an NCHW image. The relative-position index and the
shifted-window mask are static numpy tables held as buffers. LayerNorm's
epsilon is Flax's 1e-6. Every public module runs on ``device`` ("cuda"
unless the caller asks for the CPU); initialisation as in models/vit.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from einops import rearrange
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.vit import LN_EPS, gelu
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (num_windows*B, ws, ws, C) (Swin_ViT.py:207-219)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition (Swin_ViT.py:344-358)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """Pairwise relative-position index table (Swin_ViT.py:252-263)."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)                                        # (wh*ww, wh*ww)


def shifted_window_mask(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """0/-100 attention mask for SW-MSA (Swin_ViT.py:404-425)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window_size, window_size,
                          w // window_size, window_size, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class Mlp(nn.Module):
    """fc -> GELU -> fc (Swin_ViT.py:325-341)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, device="cuda"):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = nn.Dropout(drop)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(gelu(self.fc1(x)))))


class WindowAttention(nn.Module):
    """W-MSA with learned relative position bias (Swin_ViT.py:222-322)."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        wh, ww = window_size
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        table = torch.empty((2 * wh - 1) * (2 * ww - 1), num_heads)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, self.num_heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, self.num_heads, n, n)
        attn = self.attn_drop(torch.softmax(attn, dim=-1))
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj_drop(self.proj(x))


class SwinTransformerBlock(nn.Module):
    """One (S)W-MSA + MLP block with cyclic shift (Swin_ViT.py:361-477).
    A resolution no larger than the window takes one window and no shift."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        if min(self.input_resolution) <= window_size:
            shift_size = 0
            window_size = min(self.input_resolution)
        assert 0 <= shift_size < window_size
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads, qkv_bias,
                                    qk_scale, attn_drop, drop, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, device)
        mask = (torch.from_numpy(shifted_window_mask(*self.input_resolution, window_size,
                                                     shift_size)) if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        ws, s = self.window_size, self.shift_size
        b, l, c = x.shape
        assert l == h * w, "input feature has wrong size"

        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        xw = window_partition(x, ws).reshape(-1, ws * ws, c)
        xw = self.attn(xw, self.attn_mask).reshape(-1, ws, ws, c)
        x = window_reverse(xw, ws, h, w)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + x.reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Image -> non-overlapping patch tokens via strided conv
    (Swin_ViT.py:160-204). Input NCHW; the convolution runs under
    ``fp32_convs()``."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, embed_dim: int = 96,
                 use_norm: bool = False, in_chans: int = 3, device="cuda"):
        super().__init__()
        self.img_size = img_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if use_norm else None
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[2] == self.img_size and x.shape[3] == self.img_size
        with fp32_convs():
            x = self.proj(x).flatten(2).transpose(1, 2)
        return x if self.norm is None else self.norm(x)


class PatchMerging(nn.Module):
    """Down-sample: H,W -> /2, C -> x2 via 2x2 concat + linear reduce
    (Swin_ViT.py:110-157)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, l, c = x.shape
        assert l == h * w and h % 2 == 0 and w % 2 == 0
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


def _shuffle_up(x: torch.Tensor, h: int, w: int, s: int, c: int) -> torch.Tensor:
    """(B, H*W, s*s*c) tokens -> (B, H*s*W*s, c) by pixel shuffle."""
    b, l, _ = x.shape
    assert l == h * w
    x = rearrange(x.reshape(b, h, w, -1), "b h w (p1 p2 c) -> b (h p1) (w p2) c",
                  p1=s, p2=s, c=c)
    return x.reshape(b, -1, c)


class PatchExpand2X(nn.Module):
    """Up-sample x2: linear expand to 2C then pixel-shuffle, C -> C/2
    (Swin_ViT.py:9-30)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dim_scale: int = 2,
                 device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.expand = nn.Linear(dim, 2 * dim, bias=False) if dim_scale == 2 else None
        self.c_out = (2 * dim if dim_scale == 2 else dim) // 4
        self.norm = nn.LayerNorm(self.c_out, eps=LN_EPS)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand is not None:
            x = self.expand(x)
        return self.norm(_shuffle_up(x, *self.input_resolution, 2, self.c_out))


class PatchExpand(nn.Module):
    """Up-sample x`dim_scale`: linear expand to scale*C then
    pixel-shuffle to (scale*C) // 2**scale channels (Swin_ViT.py:33-56)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dim_scale: int = 2,
                 device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.s = dim_scale
        self.expand = nn.Linear(dim, dim_scale * dim, bias=False)
        self.c_out = dim_scale * dim // 2**dim_scale
        self.norm = nn.LayerNorm(self.c_out, eps=LN_EPS)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_shuffle_up(self.expand(x), *self.input_resolution, self.s, self.c_out))


class DimReducePatchExpand(nn.Module):
    """Parameter-free pixel-shuffle upsample, then LayerNorm
    (Swin_ViT.py:59-81)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dim_scale: int = 2,
                 device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.s = dim_scale
        self.c_out = dim // 2**dim_scale
        self.norm = nn.LayerNorm(self.c_out, eps=LN_EPS)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_shuffle_up(x, *self.input_resolution, self.s, self.c_out))


class FinalPatchExpandX4(nn.Module):
    """Up-sample x4 keeping dim: expand to 16C then shuffle
    (Swin_ViT.py:84-107)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dim_scale: int = 4,
                 device="cuda"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.s, self.dim = dim_scale, dim
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _shuffle_up(self.expand(x), *self.input_resolution, self.s, 16 * self.dim // self.s**2)
        return self.norm(x.reshape(x.shape[0], -1, self.dim))
