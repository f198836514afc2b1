"""Primitive layers of the JSCE codec: GDN and SE (PyTorch port of the JAX
package's models/layers.py). Its per-channel PReLU (init 0.25) and
hard-swish gate are torch's own ``nn.PReLU(C)`` and ``F.hardswish``.

NCHW throughout. GDN keeps the reference's reparameterised sqrt form of
beta and gamma (codec/models/basic_blocks/GDN.py:7-92), so a checkpoint's
leaves map one to one. The gradient rule of the reparameterisation's
lower bound belongs to training and is not ported yet: the forward takes
``max(x, bound)``.

``fp32_convs()`` is the numerical contract of the codec's forward on a
card: cuDNN convolutions default to TF32, which moves the latent by about
1e-3 relative, so the encoder and decoder run their convolutions in full
float32 with deterministic algorithms inside it. Faster precisions are
later work.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn


class _Fp32Convs:
    """``fp32_convs()``: cuDNN in full float32 (no TF32) with deterministic
    algorithms, through ``torch.backends.cudnn.flags``, for the
    convolutions run inside. cuDNN's flags belong to the process, not to a
    thread, so the first caller in sets them and the last one out restores
    them: two threads that run the codec at once (a sender app's encode, a
    receiver's decode) never convolve under flags the other restored."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inside = 0
        self._flags = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._inside == 0:
                cudnn = torch.backends.cudnn
                self._flags = cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                                          deterministic=True, allow_tf32=False)
                self._flags.__enter__()
            self._inside += 1
        try:
            yield
        finally:
            with self._lock:
                self._inside -= 1
                if self._inside == 0:
                    self._flags.__exit__(None, None, None)


fp32_convs = _Fp32Convs()


class GDN(nn.Module):
    """Generalized divisive normalization y = x / sqrt(beta + gamma @ x^2)
    over channels (inverse: multiply)."""

    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, reparam_offset: float = 2.0 ** -18):
        super().__init__()
        self.inverse = inverse
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        self.beta = nn.Parameter(torch.sqrt(torch.ones(channels) + self.pedestal))
        self.gamma = nn.Parameter(torch.sqrt(gamma_init * torch.eye(channels) + self.pedestal))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = torch.clamp(self.beta, min=self.beta_bound) ** 2 - self.pedestal
        gamma = torch.clamp(self.gamma, min=self.gamma_bound) ** 2 - self.pedestal
        # out_c = sum_in gamma[out, in] * x_in^2 + beta[out]
        norm = torch.sqrt(F.conv2d(x * x, gamma[:, :, None, None], beta))
        return x * norm if self.inverse else x / norm


class SeModule(nn.Module):
    """Squeeze-excitation: spatial mean -> 1x1 conv -> BN -> ReLU -> 1x1
    conv -> hard-sigmoid gate (RCB_DS.py:3-17)."""

    def __init__(self, in_size: int, reduction: int = 4):
        super().__init__()
        expand = max(in_size // reduction, 8)
        self.conv1 = nn.Conv2d(in_size, expand, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(expand, eps=1e-5)
        self.conv2 = nn.Conv2d(expand, in_size, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.bn1(self.conv1(s)))
        return x * F.hardsigmoid(self.conv2(s))
