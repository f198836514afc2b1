"""Constellation mapping and soft demapping (max-log LLR).

PyTorch port of the JAX package's phy/mapping.py. LLR sign convention:
llr = d0 - d1 (min squared distance to a bit-0 point minus min squared
distance to a bit-1 point), so llr > 0 favours bit 1. Punctured positions
carry llr = 0 (erasure).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


@functools.cache
def _point_bits(n_bpsc: int) -> np.ndarray:
    """(M, n_bpsc) bit matrix of each constellation point's label, in
    transmission order (bit 0 = first transmitted = MSB of the index)."""
    v = np.arange(2**n_bpsc, dtype=np.uint32)
    return ((v[:, None] >> (n_bpsc - 1 - np.arange(n_bpsc))) & 1).astype(np.int8)


def _points(n_bpsc: int, device) -> torch.Tensor:
    return torch.as_tensor(params.constellation(n_bpsc), device=device)


def map_bits(bits: torch.Tensor, mcs: int) -> torch.Tensor:
    """(..., n*n_bpsc) bits -> (..., n) complex constellation symbols."""
    n_bpsc = int(params.MCS_N_BPSC[mcs])
    b = bits.reshape(bits.shape[:-1] + (-1, n_bpsc)).long()
    weights = 1 << (n_bpsc - 1 - torch.arange(n_bpsc, device=bits.device))
    return _points(n_bpsc, bits.device)[(b * weights).sum(dim=-1)]


def demap_llr(symbols: torch.Tensor, mcs: int, csi: torch.Tensor | None = None) -> torch.Tensor:
    """Max-log LLRs for equalized symbols (..., n) complex, optionally
    weighted by per-symbol reliabilities ``csi`` (..., n). Returns
    (..., n*n_bpsc) float32 (llr > 0 favours bit 1)."""
    n_bpsc = int(params.MCS_N_BPSC[mcs])
    points = _points(n_bpsc, symbols.device)                      # (M,)
    mask1 = torch.as_tensor(_point_bits(n_bpsc) == 1, device=symbols.device
                            ).to(torch.float32)                   # (M, n_bpsc)
    d = (symbols[..., None] - points).abs() ** 2                  # (..., n, M)
    big = 1e9
    d0 = (d[..., None] + big * mask1).amin(dim=-2)                # (..., n, n_bpsc)
    d1 = (d[..., None] + big * (1.0 - mask1)).amin(dim=-2)
    llr = (d0 - d1).to(torch.float32)
    if csi is not None:
        llr = llr * csi[..., None].to(torch.float32)
    return llr.reshape(symbols.shape[:-1] + (symbols.shape[-1] * n_bpsc,))


def decide(symbols: torch.Tensor, mcs: int) -> torch.Tensor:
    """Nearest constellation point per symbol (hard decision), same shape."""
    points = _points(int(params.MCS_N_BPSC[mcs]), symbols.device)
    idx = torch.argmin((symbols[..., None] - points).abs() ** 2, dim=-1)
    return points[idx]
