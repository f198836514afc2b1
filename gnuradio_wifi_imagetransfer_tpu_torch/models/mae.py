"""Masked autoencoders (PyTorch port of the JAX package's models/mae.py):
the lightweight MAE wrapper around the CrossAttention ViT
(codec/models/basic_blocks/MAE.py:9-187) and the full FAIR
MaskedAutoencoderViT (models_mae.py:22-251) with the base/large/huge
factories.

Images are NCHW; a patch's features are in (p, q, c) order, as the JAX
package's NHWC patchify gives them. Masking is a stable argsort of
uniform noise. The noise is drawn from a ``torch.Generator``, or passed
in as ``noise=`` (the deterministic body, which the tests feed with the
JAX package's draws). Every public module runs on ``device`` ("cuda"
unless the caller asks for the CPU); initialisation as in models/vit.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from einops import rearrange
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.models.pos_embed import get_2d_sincos_pos_embed
from gnuradio_wifi_imagetransfer_tpu_torch.models.vit import LN_EPS, Transformer, gelu, pair
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def uniform_noise(noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
                  shape, device) -> torch.Tensor:
    """``noise`` if given, else U[0, 1) draws of ``shape`` from ``generator``."""
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("masking needs a torch.Generator or the noise itself")
    return torch.rand(shape, generator=generator, device=device)


# ---------------------------------------------------------------------------
# Wrapper MAE around the CrossAttention ViT (MAE.py)
# ---------------------------------------------------------------------------


class MAE(nn.Module):
    """Mask -> encode visible tokens (with optional context) -> decode all
    tokens -> reconstruct masked patches (MAE.py:53-117, encode :119-160,
    decode :162-187). State flows explicitly: ``encode`` returns
    (decoder_tokens, aux) and ``decode`` consumes aux."""

    def __init__(self, image_size=64, patch_size=8, encoder_dim: int = 256,
                 encoder_depth: int = 4, encoder_heads: int = 8, decoder_dim: int = 256,
                 masking_ratio: float = 0.75, decoder_depth: int = 1, decoder_heads: int = 8,
                 decoder_dim_head: int = 64, device="cuda"):
        super().__init__()
        assert 0 < masking_ratio < 1
        ih, iw = pair(image_size)
        self.ph, self.pw = pair(patch_size)
        self.num_patches = (ih // self.ph) * (iw // self.pw)
        self.pixels_per_patch = self.ph * self.pw * 3
        self.masking_ratio = masking_ratio
        self.decoder_dim = decoder_dim

        # encoder side (the wrapped ViT's embedding + transformer)
        self.patch_norm1 = nn.LayerNorm(self.pixels_per_patch, eps=LN_EPS)
        self.patch_embed = nn.Linear(self.pixels_per_patch, encoder_dim)
        self.patch_norm2 = nn.LayerNorm(encoder_dim, eps=LN_EPS)
        self.pos_embedding = nn.Parameter(torch.randn(1, self.num_patches, encoder_dim))
        self.transformer = Transformer(encoder_dim, encoder_depth, encoder_heads, 64,
                                       encoder_dim * 2, device=device)

        # decoder side (MAE.py:36-42)
        self.enc_to_dec = (nn.Linear(encoder_dim, decoder_dim) if encoder_dim != decoder_dim
                           else nn.Identity())
        self.mask_token = nn.Parameter(torch.randn(decoder_dim))
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads, decoder_dim_head,
                                   decoder_dim * 4, device=device)
        self.decoder_pos_emb = nn.Embedding(self.num_patches, decoder_dim)
        self.to_pixels = nn.Linear(decoder_dim, self.pixels_per_patch)
        self.to(resolve(device))

    def _patchify(self, img: torch.Tensor) -> torch.Tensor:
        """NCHW image -> (B, L, p*p*3) raw patches."""
        return rearrange(img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=self.ph, p2=self.pw)

    def forward(self, img: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward: the masked-patch reconstruction loss (MAE.py:53-117)."""
        dec_tokens, aux = self.encode(img, context, generator, noise)
        loss, _ = self.decode(dec_tokens, aux, context)
        return loss

    def encode(self, img: torch.Tensor, context: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        patches = self._patchify(img)
        b = patches.shape[0]
        tokens = self.patch_norm2(self.patch_embed(self.patch_norm1(patches)))
        tokens = tokens + self.pos_embedding[:, : self.num_patches]

        num_masked = int(self.masking_ratio * self.num_patches)
        noise = uniform_noise(noise, generator, (b, self.num_patches), img.device)
        rand_indices = torch.argsort(noise, dim=-1, stable=True)
        masked_idx = rand_indices[:, :num_masked]
        unmasked_idx = rand_indices[:, num_masked:]
        batch_range = torch.arange(b, device=img.device)[:, None]

        vis = tokens[batch_range, unmasked_idx]
        masked_patches = patches[batch_range, masked_idx]
        ctx = None if context is None else context[:, :, : vis.shape[2]]
        dec_tokens = self.enc_to_dec(self.transformer(vis, ctx))
        aux = dict(masked_idx=masked_idx, unmasked_idx=unmasked_idx,
                   masked_patches=masked_patches, batch=b)
        return dec_tokens, aux

    def decode(self, dec_tokens: torch.Tensor, aux: dict,
               context: Optional[torch.Tensor] = None):
        """-> (loss on the masked patches, NCHW reconstruction)."""
        b = aux["batch"]
        masked_idx, unmasked_idx = aux["masked_idx"], aux["unmasked_idx"]
        batch_range = torch.arange(b, device=dec_tokens.device)[:, None]

        unmasked_dec = dec_tokens + self.decoder_pos_emb(unmasked_idx)
        mask_toks = self.mask_token + self.decoder_pos_emb(masked_idx)
        full = dec_tokens.new_zeros((b, self.num_patches, self.decoder_dim))
        full = full.index_put((batch_range, unmasked_idx), unmasked_dec)
        full = full.index_put((batch_range, masked_idx), mask_toks)
        ctx = None if context is None else context[:, :, : full.shape[2]]
        decoded = self.decoder(full, ctx)

        pred_masked = self.to_pixels(decoded[batch_range, masked_idx])
        recon_loss = torch.mean((pred_masked - aux["masked_patches"]) ** 2)

        side = int((self.num_patches * self.pixels_per_patch // 3) ** 0.5)
        recon = rearrange(self.to_pixels(decoded), "b (h w) (p1 p2 c) -> b c (h p1) (w p2)",
                          h=side // self.ph, p1=self.ph, p2=self.pw)
        return recon_loss, recon


# ---------------------------------------------------------------------------
# Full FAIR MaskedAutoencoderViT (models_mae.py)
# ---------------------------------------------------------------------------


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention as self-attention with
    qkv_features = out_features = dim: query, key and value projections
    (Flax's (dim, heads, head_dim) DenseGeneral kernels), the query scaled
    by head_dim ** -0.5, softmax, the output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (rearrange(p(x), "b n (h d) -> b h n d", h=self.num_heads)
                   for p in (self.query, self.key, self.value))
        q = q * q.shape[-1] ** -0.5
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out(rearrange(attn @ v, "b h n d -> b n (h d)"))


class TimmBlock(nn.Module):
    """Standard pre-norm ViT block (the timm Block used at
    models_mae.py:40-42): MHSA with qkv bias + 4x MLP, residuals."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, device="cuda"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadDotProductAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


class MaskedAutoencoderViT(nn.Module):
    """MAE with ViT backbone (models_mae.py:22-230): conv patch embed,
    fixed sin-cos pos embeds, cls token, random masking, asymmetric
    encoder/decoder, per-patch normalized-pixel loss option. The patch
    embedding (Flax's stride-p Conv with padding SAME, which pads nothing
    at the image sizes num_patches assumes) runs under ``fp32_convs()``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = False, device="cuda"):
        super().__init__()
        p, d = patch_size, embed_dim
        self.patch_size = p
        self.depth, self.decoder_depth = depth, decoder_depth
        self.norm_pix_loss = norm_pix_loss
        self.num_patches = (img_size // p) ** 2
        grid = int(self.num_patches**0.5)

        self.patch_embed = nn.Conv2d(in_chans, d, p, stride=p)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, d))
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(d, grid, cls_token=True))[None], persistent=False)
        self.register_buffer("decoder_pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(decoder_embed_dim, grid, cls_token=True))[None],
            persistent=False)
        for i in range(depth):
            setattr(self, f"block{i}", TimmBlock(d, num_heads, mlp_ratio, device))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.decoder_embed = nn.Linear(d, decoder_embed_dim)
        self.mask_token = nn.Parameter(0.02 * torch.randn(1, 1, decoder_embed_dim))
        for i in range(decoder_depth):
            setattr(self, f"dec_block{i}",
                    TimmBlock(decoder_embed_dim, decoder_num_heads, mlp_ratio, device))
        self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=LN_EPS)
        self.decoder_pred = nn.Linear(decoder_embed_dim, p * p * in_chans)
        self.to(resolve(device))

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> (N, L, p*p*3) (models_mae.py:102-114)."""
        p = self.patch_size
        return rearrange(imgs, "n c (h p) (w q) -> n (h w) (p q c)", p=p, q=p)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, L, p*p*3) -> (N, 3, H, W)."""
        p, h = self.patch_size, int(x.shape[1] ** 0.5)
        return rearrange(x, "n (h w) (p q c) -> n c (h p) (w q)", h=h, p=p, q=p)

    def random_masking(self, x: torch.Tensor, mask_ratio: float, noise: torch.Tensor):
        """argsort-of-noise shuffling (models_mae.py:132-158); noise (N, L)."""
        n, l, d = x.shape
        len_keep = int(l * (1 - mask_ratio))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
        mask = torch.ones((n, l), device=x.device)
        mask[:, :len_keep] = 0
        mask = torch.gather(mask, 1, ids_restore)
        return x_masked, mask, ids_restore

    def forward_encoder(self, imgs: torch.Tensor, mask_ratio: float, noise: torch.Tensor):
        with fp32_convs():
            x = self.patch_embed(imgs)
        x = x.flatten(2).transpose(1, 2) + self.pos_embed[:, 1:, :]
        x, mask, ids_restore = self.random_masking(x, mask_ratio, noise)
        cls = (self.cls_token + self.pos_embed[:, :1, :]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x), mask, ids_restore

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        x = self.decoder_embed(x)
        n, d = x.shape[0], x.shape[2]
        n_mask = ids_restore.shape[1] + 1 - x.shape[1]
        x_ = torch.cat([x[:, 1:, :], self.mask_token.expand(n, n_mask, -1)], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(-1, -1, d))
        x = torch.cat([x[:, :1, :], x_], dim=1) + self.decoder_pos_embed
        for i in range(self.decoder_depth):
            x = getattr(self, f"dec_block{i}")(x)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:, :]

    def forward_loss(self, imgs: torch.Tensor, pred: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        target = self.patchify(imgs)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred - target) ** 2).mean(dim=-1)
        return (loss * mask).sum() / mask.sum()

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """-> (loss, pred (N, L, p*p*3), mask (N, L), 1 where masked)."""
        noise = uniform_noise(noise, generator, (imgs.shape[0], self.num_patches), imgs.device)
        latent, mask, ids_restore = self.forward_encoder(imgs, mask_ratio, noise)
        pred = self.forward_decoder(latent, ids_restore)
        return self.forward_loss(imgs, pred, mask), pred, mask


# Recommended archs (models_mae.py:233-251)
mae_vit_base_patch16 = partial(MaskedAutoencoderViT, patch_size=16,
                               embed_dim=768, depth=12, num_heads=12,
                               decoder_embed_dim=512, decoder_depth=8,
                               decoder_num_heads=16, mlp_ratio=4.0)
mae_vit_large_patch16 = partial(MaskedAutoencoderViT, patch_size=16,
                                embed_dim=1024, depth=24, num_heads=16,
                                decoder_embed_dim=512, decoder_depth=8,
                                decoder_num_heads=16, mlp_ratio=4.0)
mae_vit_huge_patch14 = partial(MaskedAutoencoderViT, patch_size=14,
                               embed_dim=1280, depth=32, num_heads=16,
                               decoder_embed_dim=512, decoder_depth=8,
                               decoder_num_heads=16, mlp_ratio=4.0)
