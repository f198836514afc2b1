"""Conditional VAE over the GDN encoder/decoder pair (PyTorch port of the
JAX package's models/vae.py, codec/models/basic_blocks/
ConditionalVAE.py:15-146 and BASE_VAE.py:7-31). Class-label conditioning:
the label embeds to an extra image plane on encode and concatenates to the
latent on decode.

The JAX package's two departures from the reference, which cannot run as
written, are kept: the encoder takes input_channel=4 (image embed 3 +
class plane 1, ConditionalVAE.py:30-33,94-98), and decoder_input takes
the concatenated latent_dim + embedding_dim (:103).

NCHW; the latent flattens in the JAX package's (h, w, c) order, so its
dense kernels carry over. The draws (reparameterisation, prior samples)
come from a ``torch.Generator`` or are passed in (``eps=``, ``z=``).
``final_bn`` is Flax's BatchNorm with running averages (the port's
``layers.BatchNorm`` outside training). Runs on ``device`` ("cuda" unless
the caller asks for the CPU); its own convolutions run under
``fp32_convs()``, as the encoder's and decoder's do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.models.decoder import DecoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.encoder import EncoderPE
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import BatchNorm, fp32_convs
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def _normal(draws: Optional[torch.Tensor], generator: Optional[torch.Generator],
            shape, device) -> torch.Tensor:
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError("the draw needs a torch.Generator or the draws themselves")
    return torch.randn(shape, generator=generator, device=device)


class ConditionalVAE(nn.Module):
    def __init__(self, in_channels: int = 3, embedding_dim: int = 10,
                 compressed_channel: int = 128, img_size: int = 64,
                 feature_scale: float = 1.0, device="cuda"):
        super().__init__()
        self.img_size, self.compressed_channel = img_size, compressed_channel
        self.compressed_size = img_size // 8
        self.feature_dim = compressed_channel * self.compressed_size**2
        self.latent_dim = int(self.feature_dim * feature_scale)
        self.embed_class = nn.Linear(embedding_dim, img_size * img_size)
        self.embed_data = nn.Conv2d(in_channels, 3, 1)
        self.encoder = EncoderPE(compressed_channel, input_channel=4)
        self.fc_mu = nn.Linear(self.feature_dim, self.latent_dim)
        self.fc_var = nn.Linear(self.feature_dim, self.latent_dim)
        self.decoder_input = nn.Linear(self.latent_dim + embedding_dim, self.feature_dim)
        self.decoder = DecoderPE(compressed_channel, reconstruct_channel=3)
        # final BN -> LeakyReLU -> Conv3x3 -> Tanh (ConditionalVAE.py:44-52)
        self.final_bn = BatchNorm(3)
        self.final_conv = nn.Conv2d(3, 3, 3, padding=1)
        self.to(resolve(device))

    def encode(self, x: torch.Tensor, sub_csi: Optional[torch.Tensor] = None):
        """-> [mu, log_var] (ConditionalVAE.py:54-69)."""
        result = self.encoder(x, sub_csi).permute(0, 2, 3, 1).flatten(1)
        return self.fc_mu(result), self.fc_var(result)

    def decode(self, z: torch.Tensor, sub_csi: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.compressed_size
        result = self.decoder_input(z).reshape(-1, s, s, self.compressed_channel)
        result = self.decoder(result.permute(0, 3, 1, 2).contiguous(), sub_csi)
        with fp32_convs():
            return torch.tanh(self.final_conv(F.leaky_relu(self.final_bn(result), 0.01)))

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return eps * torch.exp(0.5 * logvar) + mu

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                sub_csi: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """-> [reconstruction, input, mu, log_var] (ConditionalVAE.py:91-103)."""
        embedded_class = self.embed_class(labels).reshape(-1, 1, self.img_size, self.img_size)
        with fp32_convs():
            embedded_input = self.embed_data(x)
        mu, log_var = self.encode(torch.cat([embedded_input, embedded_class], dim=1), sub_csi)
        z = self.reparameterize(mu, log_var, _normal(eps, generator, mu.shape, mu.device))
        return self.decode(torch.cat([z, labels], dim=1), sub_csi), x, mu, log_var

    def sample(self, num_samples: int, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sub_csi: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode latents drawn from the prior (ConditionalVAE.py:121-140)."""
        z = _normal(z, generator, (num_samples, self.latent_dim), labels.device)
        return self.decode(torch.cat([z, labels.float()], dim=1), sub_csi)

    def generate(self, x: torch.Tensor, labels: torch.Tensor,
                 sub_csi: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self(x, labels, sub_csi, generator, eps)[0]


def vae_loss(recons: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             log_var: torch.Tensor, kld_weight: float) -> dict:
    """MSE + weighted KLD (ConditionalVAE.py:105-119)."""
    recons_loss = torch.mean((recons - x) ** 2)
    kld = torch.mean(-0.5 * torch.sum(1 + log_var - mu**2 - torch.exp(log_var), dim=1))
    return {"loss": recons_loss + kld_weight * kld,
            "Reconstruction_Loss": recons_loss, "KLD": -kld}
