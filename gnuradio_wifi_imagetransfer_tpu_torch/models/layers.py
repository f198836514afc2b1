"""Primitive layers of the JSCE codec: GDN, SE and BatchNorm (PyTorch port
of the JAX package's models/layers.py). Its per-channel PReLU (init 0.25)
and hard-swish gate are torch's own ``nn.PReLU(C)`` and ``F.hardswish``.

NCHW throughout. GDN keeps the reference's reparameterised sqrt form of
beta and gamma (codec/models/basic_blocks/GDN.py:7-92), so a checkpoint's
leaves map one to one, and the reparameterisation's lower bound keeps the
reference's gradient rule (``LowerBound``): a gradient passes where the
leaf is at or above the bound, or where it pushes the leaf up. At
initialisation every off-diagonal gamma sits exactly on its bound, so the
rule decides training from the first step that moves one below it.

``BatchNorm`` has Flax's training semantics (the JAX package's blocks use
``flax.linen.BatchNorm``), which differ from ``nn.BatchNorm2d``'s: the
running averages move by 1 % a step (Flax's momentum 0.99) and the running
variance takes the biased batch variance. The mode is the ``train``
argument of each forward, as in the JAX package, not ``Module.training``.

``fp32_convs()`` is the numerical contract of the codec's forward on a
card: cuDNN convolutions default to TF32, which moves the latent by about
1e-3 relative, so the encoder and decoder run their convolutions in full
float32 with deterministic algorithms inside it. Faster precisions are
later work.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

import torch
import torch.distributed.nn.functional as dist_fn
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


class LowerBound(torch.autograd.Function):
    """max(x, bound) with the reference's gradient rule (GDN.py
    LowerBound:7-23): the gradient g passes where x >= bound or g < 0,
    else 0."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, bound: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return LowerBound.apply(x, bound)


_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def global_batch(group):
    """Within the block (in this thread), BatchNorm in train mode takes its
    statistics over the whole batch of the ``torch.distributed`` group
    (None: over the local batch)."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW channels with Flax's semantics (eps 1e-5). With
    ``train``, it normalises by the batch's mean and biased variance
    (Flax's E[x^2] - E[x]^2, floored at 0) and moves the running averages
    to 0.99 * running + 0.01 * batch; else it normalises by the running
    averages. The state_dict is nn.BatchNorm2d's.

    Inside ``global_batch(group)`` (the trainer's data-parallel step), the
    batch is the group's whole batch, as under JAX's pjit: the per-channel
    sums of x and x^2 and the count are all-reduced with autograd (the
    gradient of a sum over ranks is the sum of every rank's gradient)
    before the mean and variance are formed."""

    MOMENTUM = 0.99

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=1.0 - self.MOMENTUM)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dims = (0, 2, 3)
        group = _BATCH_GROUP.get()
        if group is None:
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        else:
            c = x.shape[1]
            sums = dist_fn.all_reduce(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                                                 x.new_full((1,), x.numel() // c)]), group=group)
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c: 2 * c] / sums[-1] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(mean.detach(), alpha=1.0 - self.MOMENTUM)
            self.running_var.mul_(self.MOMENTUM).add_(var.detach(), alpha=1.0 - self.MOMENTUM)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


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
        beta = lower_bound(self.beta, self.beta_bound) ** 2 - self.pedestal
        gamma = lower_bound(self.gamma, self.gamma_bound) ** 2 - self.pedestal
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
        self.bn1 = BatchNorm(expand)
        self.conv2 = nn.Conv2d(expand, in_size, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.bn1(self.conv1(s), train))
        return x * F.hardsigmoid(self.conv2(s))
