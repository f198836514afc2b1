"""Vision-Transformer primitives (PyTorch port of the JAX package's
models/vit.py, codec/models/basic_blocks/ViT.py:19-174): pre-norm
attention, talking-heads cross-attention, the CrossAttention Transformer
stack, and the ViT image encoder.

Flax's defaults decide the numerics: LayerNorm's epsilon is 1e-6 and GELU
is the tanh approximation. Attention is a plain product and softmax (the
head mix sits between the scores and the softmax). Dropout is torch's,
active in train mode; the reference instantiates with dropout 0.

Every public module runs on ``device`` ("cuda" unless the caller asks for
the CPU). torch layers initialise by torch's defaults; the parameters a
module declares itself draw from the JAX package's initialisers; both from
torch's global generator. ``weights.state_dict_from_flax`` carries a JAX
init in (the submodules carry the Flax names).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

LN_EPS = 1e-6            # flax.linen.LayerNorm's default epsilon


def pair(t):
    return t if isinstance(t, tuple) else (t, t)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax.linen.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class FeedForward(nn.Module):
    """LayerNorm -> Linear -> GELU -> Linear (ViT.py:19-32)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop = nn.Dropout(dropout)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(gelu(self.fc1(self.norm(x))))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Pre-norm multi-head self-attention (ViT.py:35-69)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = nn.Linear(inner, dim) if project_out else None
        self.drop = nn.Dropout(dropout)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        q, k, v = (rearrange(t, "b n (h d) -> b h n d", h=self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head**-0.5, dim=-1)
        out = rearrange(self.drop(attn) @ v, "b h n d -> b n (h d)")
        if self.to_out is not None:
            out = self.drop(self.to_out(out))
        return out


class CrossAttention(nn.Module):
    """Talking-heads cross-attention (ViT.py:72-115): queries from the
    normed x, keys and values from [normed x ; raw context]; head-mixing
    products before and after the softmax."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.mix_heads_pre_attn = nn.Parameter(torch.randn(heads, heads))
        self.mix_heads_post_attn = nn.Parameter(torch.randn(heads, heads))
        self.to_out = nn.Linear(inner, dim)
        self.drop = nn.Dropout(dropout)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm(x)
        ctx = x if context is None else torch.cat([x, context], dim=1)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        q, k, v = (rearrange(t, "b n (h d) -> b h n d", h=self.heads)
                   for t in (self.to_q(x), k, v))
        dots = q @ k.transpose(-1, -2) * self.dim_head**-0.5
        dots = torch.einsum("bhij,hg->bgij", dots, self.mix_heads_pre_attn)
        attn = self.drop(torch.softmax(dots, dim=-1))
        attn = torch.einsum("bhij,hg->bgij", attn, self.mix_heads_post_attn)
        out = rearrange(attn @ v, "b h n d -> b n (h d)")
        return self.drop(self.to_out(out))


class Transformer(nn.Module):
    """Depth x (CrossAttention + FeedForward), with the reference's one
    post-residual LayerNorm shared by every layer and the output
    (ViT.py:118-134)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.depth = depth
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        for i in range(depth):
            setattr(self, f"attn{i}", CrossAttention(dim, heads, dim_head, dropout, device))
            setattr(self, f"ff{i}", FeedForward(dim, mlp_dim, dropout, device))
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.depth):
            x = self.norm(getattr(self, f"attn{i}")(x, context) + x)
            x = getattr(self, f"ff{i}")(x) + x
        return self.norm(x)


class ViT(nn.Module):
    """Patchify -> linear embed -> learned pos embed -> Transformer ->
    cls/mean pool (ViT.py:137-174). Input NCHW; a patch's features are in
    (p1, p2, c) order, as the JAX package's NHWC rearrange gives them."""

    def __init__(self, image_size=224, patch_size=16, dim: int = 512, depth: int = 6,
                 heads: int = 8, mlp_dim: int = 1024, pool: str = "cls", channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        self.ph, self.pw = pair(patch_size)
        assert ih % self.ph == 0 and iw % self.pw == 0, "image not divisible by patch"
        assert pool in ("cls", "mean")
        self.pool = pool
        num_patches = (ih // self.ph) * (iw // self.pw)
        patch_dim = self.ph * self.pw * channels
        self.patch_norm1 = nn.LayerNorm(patch_dim, eps=LN_EPS)
        self.patch_embed = nn.Linear(patch_dim, dim)
        self.patch_norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches, dim))
        self.emb_drop = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, device)
        self.to(resolve(device))

    def forward(self, img: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = rearrange(img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=self.ph, p2=self.pw)
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(x)))
        x = self.emb_drop(x + self.pos_embedding[:, : x.shape[1]])
        ctx = None if context is None else context[:, :, : x.shape[2]]
        x = self.transformer(x, ctx)
        return x.mean(dim=1) if self.pool == "mean" else x[:, 0]
