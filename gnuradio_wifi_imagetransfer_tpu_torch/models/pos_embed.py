"""2-D sine-cosine position embeddings (MAE-style) and checkpoint
pos-embed interpolation (numpy port of the JAX package's
models/pos_embed.py, codec/models/basic_blocks/util/pos_embed.py:20-95).

The tables are numpy constants. ``interpolate_pos_embed`` resizes as the
JAX package's ``jax.image.resize(method="cubic")`` does: the Keys cubic
kernel with a = -0.5 at half-pixel centres, each output's weights divided
by their sum where the kernel reaches past the input (no clamped border),
and, when downsampling, a kernel widened by the scale (antialiasing).
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) [sin | cos] embedding."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega                                 # (D/2,)
    pos = pos.reshape(-1)                                      # (M,)
    out = np.einsum("m,d->md", pos, omega)                     # (M, D/2)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)              # (H*W, D)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """(grid*grid[, +1 cls], embed_dim) fixed sin-cos table; w varies
    fastest (np.meshgrid with w first, pos_embed.py:27-29)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, grid_size, grid_size])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim], np.float32), pos_embed], axis=0)
    return pos_embed


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of a cubic resize of one axis from n_in to
    n_out samples (jax.image.resize's rule, antialiased)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(pos_embed_checkpoint: np.ndarray, num_patches: int,
                          num_extra_tokens: int = 1) -> np.ndarray:
    """Resample a (1, T, D) checkpoint position table to a new patch-grid
    size by the cubic rule above, keeping the cls/dist tokens unchanged
    (pos_embed.py:76-95)."""
    embedding_size = pos_embed_checkpoint.shape[-1]
    orig_size = int((pos_embed_checkpoint.shape[-2] - num_extra_tokens) ** 0.5)
    new_size = int(num_patches**0.5)
    if orig_size == new_size:
        return pos_embed_checkpoint
    extra = pos_embed_checkpoint[:, :num_extra_tokens]
    toks = pos_embed_checkpoint[:, num_extra_tokens:].reshape(
        -1, orig_size, orig_size, embedding_size)
    w = cubic_weights(orig_size, new_size)
    toks = np.einsum("bhwd,hy,wx->byxd", toks.astype(np.float64), w, w)
    toks = toks.astype(pos_embed_checkpoint.dtype).reshape(-1, new_size * new_size, embedding_size)
    return np.concatenate([extra, toks], axis=1)
