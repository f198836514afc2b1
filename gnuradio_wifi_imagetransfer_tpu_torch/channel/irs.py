"""IRS (intelligent reflecting surface) steering-vector channels (PyTorch
port of the JAX package's channel/irs.py, the reference's utils/channel.py).

``IRSChannel`` (channel.py:43-132): LoS via 3-D Kronecker steering vectors
with carrier phase e^{-jkd}, Rayleigh NLoS, the aggregate IRS channel
H = H_B2R diag(psi) H_R2U + H_B2U, MMSE pilot channel estimation.
``ClusteredIRSChannel`` (channel.py:135-281): IRS element groups, Rician
mixing, and the phase-gradient reflection codebooks genPhase_nograd /
genIncidencePhase. They feed the SOMANet multi-user physics
(models/somanet.py) and the trainer's environment (utils/trainer.py).

Matrices lie on the channel's ``device`` ("cuda" unless the caller asks for
the CPU). Draws come from a ``torch.Generator`` on that device and go
through deterministic functions of them (``awgn_from``, ``rician_mix``),
which the tests feed with the draws the JAX package makes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.channel.sv import (
    array_response, cn, complex_normal, rician_mix)
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

C_LIGHT = 3e8


def channel_mdl(pos_a, pos_b, at_scale_a, at_scale_b, f: float = 5e9,
                device=None) -> torch.Tensor:
    """LoS channel with carrier phase: sv_A sv_B^H * e^{-j k d}
    (channel.py:60-78; the e^{-jkd} term is what distinguishes this from
    the SV_channel.py variant)."""
    pos_a = torch.as_tensor(pos_a, dtype=torch.float32, device=device)
    pos_b = torch.as_tensor(pos_b, dtype=torch.float32, device=pos_a.device)
    k = 2.0 * math.pi * f / C_LIGHT
    diff = pos_a - pos_b
    d = torch.sqrt((diff * diff).sum())
    n_ab = diff / d
    h = array_response(n_ab, at_scale_a) @ array_response(n_ab, at_scale_b).conj().T
    return (h * torch.exp(-1j * k * d)).to(torch.complex64)


def dft_matrix(n: int, device=None) -> torch.Tensor:
    """Unitary DFT matrix (channel.py DFT_matrix :124-127)."""
    i, j = torch.meshgrid(torch.arange(n, device=device), torch.arange(n, device=device),
                          indexing="xy")
    return torch.exp(-2j * math.pi * i * j / n) / torch.tensor(n, dtype=torch.float32).sqrt()


def awgn_from(draws: torch.Tensor, sigma) -> torch.Tensor:
    """Complex noise of total power sigma^2 from CN draws re + j im of unit
    variance per part: draws * sigma / sqrt(2)."""
    return (draws * (torch.as_tensor(sigma, dtype=torch.float32, device=draws.device)
                     / math.sqrt(2.0))).to(torch.complex64)


@dataclasses.dataclass(frozen=True)
class IRSChannel:
    """Functional port of utils/channel.py Channel (channel.py:43-132)."""

    user_num: int
    antenna_num: int
    irs_units: int
    device: str = "cuda"

    @property
    def scale(self) -> int:
        return int(self.irs_units ** 0.5)

    def noise(self, generator: torch.Generator, sigma) -> torch.Tensor:
        """(antenna, user) complex noise of total power sigma^2."""
        dev = resolve(self.device)
        return awgn_from(complex_normal(generator, (self.antenna_num, self.user_num), dev),
                         sigma)

    def gen_los(self, pos_ap, pos_irs, pos_users):
        """(H_B2U, H_B2R, H_R2U) LoS matrices (channel.py:101-116)."""
        dev = resolve(self.device)
        at_user = (1, 1, 1)
        at_ap = (self.antenna_num, 1, 1)
        at_irs = (self.scale, self.scale, 1)
        pos_users = torch.as_tensor(pos_users, dtype=torch.float32, device=dev)
        h_b2u = torch.stack([channel_mdl(pos_ap, pos_users[u], at_ap, at_user, device=dev)
                             .reshape(-1) for u in range(self.user_num)], dim=1)
        h_r2u = torch.stack([channel_mdl(pos_irs, pos_users[u], at_irs, at_user, device=dev)
                             .reshape(-1) for u in range(self.user_num)], dim=1)
        h_b2r = channel_mdl(pos_ap, pos_irs, at_ap, at_irs, device=dev)
        return h_b2u, h_b2r, h_r2u

    def gen_nonlos(self, generator: torch.Generator):
        """i.i.d. CN(0, 1) (H_B2U, H_B2R, H_R2U)."""
        dev = resolve(self.device)
        return (cn(generator, (self.antenna_num, self.user_num), dev),
                cn(generator, (self.antenna_num, self.irs_units), dev),
                cn(generator, (self.irs_units, self.user_num), dev))

    @staticmethod
    def get_chnl(h_b2u, h_b2r, h_r2u, psi) -> torch.Tensor:
        """Aggregate channel H = H_B2R diag(psi) H_R2U + H_B2U
        (channel.py getChnl :118-121)."""
        return h_b2r @ (psi.reshape(-1)[:, None] * h_r2u) + h_b2u

    def propagation(self, generator: torch.Generator, signal, h, sigma) -> torch.Tensor:
        """y = H s + n (channel.py propagation :80-83)."""
        return h @ signal + self.noise(generator, sigma)

    @staticmethod
    def ch_est(y_rx, sigma2, pilot) -> torch.Tensor:
        """MMSE channel estimate H_est = y pilot^H / (1 + sigma2)
        (channel.py CH_est :129-132)."""
        return y_rx @ (pilot.conj().T / (1.0 + sigma2))


@dataclasses.dataclass(frozen=True)
class ClusteredIRSChannel:
    """Port of clustered_SV_channel (channel.py:135-281): the IRS is tiled
    into group_scale^2 clusters of cluster_scale^2 elements; channels are
    defined per cluster; reflection phases come from geometric codebooks."""

    irs_unit_gap: float
    irs_scale: int
    irs_pos: tuple[float, float, float]
    ap_pos: tuple[float, float, float]
    cluster_scale: int
    user_num: int
    ap_num: int
    freq: float = 5e9
    device: str = "cuda"

    @property
    def group_scale(self) -> int:
        return self.irs_scale // self.cluster_scale

    @property
    def group_num(self) -> int:
        return self.group_scale ** 2

    def _unit_positions(self) -> np.ndarray:
        """(3, G, G) cluster-anchor coordinates (channel.py:152-158):
        x advances with the row index, y with the column index."""
        g = self.group_scale
        y = np.tile(np.arange(g), (g, 1))
        x = y.T
        return np.stack([
            self.irs_pos[0] + x * self.irs_unit_gap,
            self.irs_pos[1] + y * self.irs_unit_gap,
            np.full((g, g), self.irs_pos[2]),
        ])

    def gen_los(self, pos_users):
        """(H_U2B, H_R2B, H_U2R) LoS entries per cluster
        (channel.py genLoS :172-190): scalar [0][0] of each cluster's
        steering product."""
        dev = resolve(self.device)
        at_point = (1, 1, 1)
        at_group = (self.cluster_scale, self.cluster_scale, 1)
        pos_users = torch.as_tensor(pos_users, dtype=torch.float32, device=dev)
        pos = self._unit_positions()
        g = self.group_scale

        def mdl(a, b, at_b):
            return channel_mdl(a, b, at_point, at_b, self.freq, device=dev)[0, 0]

        h_u2b = torch.stack([mdl(self.ap_pos, pos_users[u], at_point)
                             for u in range(self.user_num)])[None, :]          # (1, U)
        u2r, r2b = [], []
        for i in range(g):
            for j in range(g):
                unit = torch.as_tensor(pos[:, i, j], dtype=torch.float32, device=dev)
                u2r.append(torch.stack([mdl(pos_users[u], unit, at_group)
                                        for u in range(self.user_num)]))
                r2b.append(mdl(self.ap_pos, unit, at_group))
        h_u2r = torch.stack(u2r)                                                # (G^2, U)
        h_r2b = torch.stack(r2b)[None, :]                                       # (1, G^2)
        return (h_u2b.expand(self.ap_num, self.user_num),
                h_r2b.expand(self.ap_num, self.group_num), h_u2r)

    def nonlos(self, generator: torch.Generator, los):
        """CN(0, 1) draws shaped as (H_U2B, H_R2B, H_U2R)."""
        return tuple(cn(generator, h.shape, h.device) for h in los)

    def gen_chnl(self, generator: torch.Generator, los, k_factor: float = 10.0):
        """Rician-refresh all three matrices (channel.py genChnl :202-211).

        los: the (H_U2B, H_R2B, H_U2R) tuple from gen_los.
        Returns (H_R2B, H_U2R, H_d).
        """
        h_d, h_r2b, h_u2r = rician_mix(los, self.nonlos(generator, los), k_factor)
        return h_r2b, h_u2r, h_d

    @staticmethod
    def gen_chnl_ideal(los, psi) -> torch.Tensor:
        """Cascaded LoS-only IRS channel H_r = H_R2B diag(psi) H_U2R
        (channel.py genChnl_ideal :228-233)."""
        _, h_r2b, h_u2r = los
        return h_r2b @ (psi.reshape(-1)[:, None] * h_u2r)

    def _phase(self, arg: np.ndarray) -> torch.Tensor:
        """exp(j arg) of a float64 phase, rounded to complex64 first as the
        JAX package's jnp.exp of a numpy complex128 argument is."""
        z = torch.from_numpy(1j * arg).to(torch.complex64).to(resolve(self.device))
        return torch.exp(z)

    def gen_phase_nograd(self, theta: float, phi: float) -> torch.Tensor:
        """Reflection phase codebook steering towards (theta, phi)
        (channel.py genPhase_nograd :248-268). Returns (G, G) complex
        unit phasors. Note the reference's theta==0 special case."""
        k = 2.0 * np.pi * self.freq / C_LIGHT
        pos = self._unit_positions()
        d = np.sqrt(((pos - np.asarray(self.ap_pos)[:, None, None]) ** 2).sum(0))
        if theta != 0:
            d1 = np.sin(theta) * np.cos(phi) * pos[1]
            d2 = np.sin(theta) * np.sin(phi) * pos[0]
        else:
            d1 = np.sin(phi) * np.cos(theta) * pos[0]
            d2 = np.zeros_like(d)
        return self._phase(k * (d - d1 - d2))

    def gen_incidence_phase(self) -> torch.Tensor:
        """Incident-path phase wrapped to [-pi, pi]
        (channel.py genIncidencePhase :270-281)."""
        k = 2.0 * np.pi * self.freq / C_LIGHT
        pos = self._unit_positions()
        d = np.sqrt(((pos - np.asarray(self.ap_pos)[:, None, None]) ** 2).sum(0))
        return torch.angle(self._phase(k * d))
