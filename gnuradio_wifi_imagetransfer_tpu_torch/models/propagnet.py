"""PropagNet: IRS propagation layer with learnable phase shifts (PyTorch
port of the JAX package's models/propagnet.py,
codec/models/basic_blocks/PropagNet.py:5-73). Given an environment (H_B2R,
H_R2U, Hd), every user path is H_p = H_B2R diag(Psi) H_R2U[:, p] + Hd[:, p]
with Psi = exp(j phi), phi learnable (or zero reflection when with_irs is
False). Phases are drawn as 2 * 3.14 * U(0, 1), the reference's 3.14, not
pi. Complex64; runs on ``device`` ("cuda" unless the caller asks for the
CPU)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


class PropagNet(nn.Module):
    """env = (H_B2R (M, N), H_R2U (N, P), Hd (M, P)) complex arrays."""

    def __init__(self, env: Tuple, with_irs: bool = True, device="cuda"):
        super().__init__()
        for name, h in zip(("h_b2r", "h_r2u", "hd"), env):
            self.register_buffer(name, torch.as_tensor(h).to(torch.complex64), persistent=False)
        n = self.h_b2r.shape[1]
        self.phi = nn.Parameter(2 * 3.14 * torch.rand(n)) if with_irs else None
        self.to(resolve(device))

    def psi(self) -> torch.Tensor:
        if self.phi is None:
            # withIRS=False zeroes the reflection coefficients
            # (PropagNet.py:19-21: psi_real = psi_imag = 0)
            return torch.zeros(self.h_b2r.shape[1], dtype=torch.complex64,
                               device=self.h_b2r.device)
        return torch.complex(torch.cos(self.phi), torch.sin(self.phi))

    def get_csi(self, index: int = 0, psi: torch.Tensor | None = None) -> torch.Tensor:
        """H = H_B2R diag(Psi) H_R2U[:, index] + Hd[:, index]
        (PropagNet.py:36-43)."""
        if psi is None:
            psi = self.psi()
        return self.h_b2r @ (psi * self.h_r2u[:, index]) + self.hd[:, index]

    def forward(self, x: torch.Tensor):
        """Propagate x through every path; returns (Y (P, ...), CSI (P, M))
        (PropagNet.py:59-73)."""
        csi = (self.h_b2r @ (self.psi()[:, None] * self.h_r2u) + self.hd).T      # (P, M)
        return csi * x, csi


def refresh_psi(n: int, generator: torch.Generator) -> torch.Tensor:
    """Fresh random phases 2 * 3.14 * U(0, 1) from ``generator``, on its
    device (PropagNet.py:45-48)."""
    return 2 * 3.14 * torch.rand(n, generator=generator, device=generator.device)
