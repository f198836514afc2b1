"""Saleh-Valenzuela geometry channel (PyTorch port of the JAX package's
channel/sv.py, the reference's utils/SV_channel.py:11-102).

3-D Kronecker steering vectors, LoS matrices AP<->IRS/user, i.i.d.
Rayleigh NLoS, Rician mixing with factor K, the AWGN-only degenerate
channel, and a tapped-delay-line fading generator (``sv_impulse_response``)
for the waveform path: classic SV cluster/ray double-exponential power decay
with Rayleigh ray gains.

Each function that draws takes a ``torch.Generator`` (on the device it
draws on), where the JAX package takes a PRNG key, and hands its draws to a
deterministic function of them (``rician_mix``, ``sv_taps``): the tests
feed those the draws JAX makes and compare the rest exactly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def steering_vec(angle, n: int, device=None) -> torch.Tensor:
    """exp(j*angle*pi*[0..n)) column vector (SV_channel.py:24-31)."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=device)
    k = torch.arange(n, dtype=torch.float32, device=angle.device)
    return torch.exp(1j * (angle * math.pi) * k)[:, None].to(torch.complex64)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum())


def array_response(n_ab: torch.Tensor, scales) -> torch.Tensor:
    """The Kronecker product of the three axes' steering vectors."""
    v = steering_vec(n_ab[0], scales[0])
    v = torch.kron(v, steering_vec(n_ab[1], scales[1]))
    return torch.kron(v, steering_vec(n_ab[2], scales[2]))


def channel_mdl(pos_a, pos_b, at_scale_a, at_scale_b, device=None) -> torch.Tensor:
    """LoS channel between two uniform (possibly planar) arrays: direction
    cosines of the A->B unit vector index 3-D steering vectors which
    Kronecker-combine per array axis; H = sv_A sv_B^H (SV_channel.py:33-49)."""
    pos_a = torch.as_tensor(pos_a, dtype=torch.float32, device=device)
    pos_b = torch.as_tensor(pos_b, dtype=torch.float32, device=pos_a.device)
    n_ab = (pos_a - pos_b) / _norm(pos_a - pos_b)
    return array_response(n_ab, at_scale_a) @ array_response(n_ab, at_scale_b).conj().T


def complex_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """re + j im with re, im ~ N(0, 1), drawn re first."""
    re = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, torch.randn(shape, generator=generator, device=device))


def cn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """CN(0, 1) draws: (re + j im) / sqrt(2)."""
    return complex_normal(generator, shape, device) / math.sqrt(2.0)


def rician_mix(los, nlos, k_factor: float):
    """sqrt(K/(K+1)) * LoS + sqrt(1/(K+1)) * NLoS, term by term
    (SV_channel.py:73-79)."""
    a = math.sqrt(k_factor / (k_factor + 1.0))
    b = math.sqrt(1.0 / (k_factor + 1.0))
    return tuple((a * lo + b * nl).to(torch.complex64) for lo, nl in zip(los, nlos))


@dataclasses.dataclass(frozen=True)
class SVChannel:
    """Geometry container mirroring Saleh_Valenzuela_Channel.__init__
    (SV_channel.py:12-22). Its matrices lie on ``device``."""

    irs_scale: int
    irs_pos: tuple[float, float, float]
    ap_pos: tuple[float, float, float]
    user_num: int
    antenna_num: int
    device: str = "cuda"

    @property
    def n_units(self) -> int:
        return self.irs_scale ** 2

    def gen_los(self, pos_users) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(H_B2R, H_R2U, H_B2U) LoS matrices (SV_channel.py:58-72)."""
        dev = resolve(self.device)
        at_user = (1, 1, 1)
        at_ap = (self.antenna_num, 1, 1)
        at_irs = (self.irs_scale, self.irs_scale, 1)
        pos_users = torch.as_tensor(pos_users, dtype=torch.float32, device=dev)
        h_b2u = torch.stack([channel_mdl(self.ap_pos, pos_users[u], at_ap, at_user, dev)
                             .reshape(-1) for u in range(self.user_num)], dim=1)   # (ant, U)
        h_r2u = torch.stack([channel_mdl(self.irs_pos, pos_users[u], at_irs, at_user, dev)
                             .reshape(-1) for u in range(self.user_num)], dim=1)   # (N, U)
        h_b2r = channel_mdl(self.ap_pos, self.irs_pos, at_ap, at_irs, dev)  # (ant, N)
        return h_b2r, h_r2u, h_b2u

    def gen_nonlos(self, generator: torch.Generator):
        """i.i.d. CN(0,1) Rayleigh matrices (SV_channel.py:52-56)."""
        dev = resolve(self.device)
        return (cn(generator, (self.antenna_num, self.n_units), dev),
                cn(generator, (self.n_units, self.user_num), dev),
                cn(generator, (self.antenna_num, self.user_num), dev))

    def gen_rician(self, generator: torch.Generator, pos_users, k_factor: float = 10.0):
        """Rician mix of gen_los and gen_nonlos (SV_channel.py:73-79)."""
        return rician_mix(self.gen_los(pos_users), self.gen_nonlos(generator), k_factor)

    def gen_rayleigh(self, pos_users):
        """Pure LoS matrices (the reference's genRayleigh just returns LoS,
        SV_channel.py:86-88)."""
        return self.gen_los(pos_users)

    def gen_awgn(self):
        """Degenerate direct channel: zeros via IRS, ones AP->user
        (SV_channel.py:92-95)."""
        dev = resolve(self.device)
        return (torch.zeros((self.antenna_num, self.n_units), dtype=torch.complex64, device=dev),
                torch.zeros((self.n_units, self.user_num), dtype=torch.complex64, device=dev),
                torch.ones((self.antenna_num, self.user_num), dtype=torch.complex64, device=dev))

    @staticmethod
    def aggregate(h_b2r, h_r2u, h_b2u, psi) -> torch.Tensor:
        """H = H_B2R diag(psi) H_R2U + H_B2U (SV_channel.py __main__:126)."""
        return h_b2r @ (psi.reshape(-1)[:, None] * h_r2u) + h_b2u


def sv_profile(n_taps: int, ray_decay: float, device=None) -> torch.Tensor:
    """The ray power profile exp(-k / ray_decay), float32."""
    k = torch.arange(n_taps, dtype=torch.float32, device=device)
    return torch.exp(-k / ray_decay)


def sv_taps(gains: torch.Tensor, mask: torch.Tensor, ray_decay: float = 2.0,
            normalize: bool = True) -> torch.Tensor:
    """The taps from their draws: CN(0, 1) ray ``gains`` and the cluster
    ``mask``, shaped by the power profile; a silent first tap becomes 1,
    and the total power 1 when ``normalize``."""
    profile = sv_profile(gains.shape[-1], ray_decay, gains.device)
    taps = gains * torch.sqrt(profile) * mask.to(torch.float32)
    first = torch.where(taps[0].abs() < 1e-6, torch.ones_like(taps[0]), taps[0])
    taps = torch.cat([first[None], taps[1:]])
    if normalize:
        taps = taps / torch.sqrt((taps.real ** 2 + taps.imag ** 2).sum())
    return taps.to(torch.complex64)


def sv_impulse_response(generator: torch.Generator, n_taps: int = 8,
                        cluster_rate: float = 0.25, ray_decay: float = 2.0,
                        normalize: bool = True) -> torch.Tensor:
    """Tapped-delay-line SV fading: exponentially decaying Rayleigh taps on
    the generator's device.

    Power profile p[k] ~ exp(-k/ray_decay) with a Poisson-ish cluster mask
    (each tap kept with probability min(1, cluster_rate + p[k])); returns
    (n_taps,) complex64 taps. Keeps delay spread within the 16-sample CP so
    the 802.11a equalizer operates in its design regime.
    """
    dev = generator.device
    gains = cn(generator, (n_taps,), dev)
    keep = torch.clamp(cluster_rate + sv_profile(n_taps, ray_decay, dev), max=1.0)
    mask = torch.rand((n_taps,), generator=generator, device=dev) < keep
    return sv_taps(gains, mask, ray_decay, normalize)
